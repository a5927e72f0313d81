"""Top-k inference with a confidence threshold, port of ``tpunet/infer/predict.py``.

image (uint8 HWC) -> /255 -> bilinear resize to ``image_size`` -> the
training normalization -> the model of the ``ModelConfig`` (MobileNetV2
or a ViT) -> softmax -> top-k (default 3);
a best probability below ``conf_threshold`` (default 0.5) is reported
as "uncertain".

The resize is ``jax.image.resize(..., "bilinear")`` exactly, which is
not ``F.interpolate``: on a downscale JAX antialiases — its triangle
kernel is widened by 1/scale — and it renormalises each output's
weights over the in-range taps. :func:`resize_weights` builds those
per-axis weight matrices, and the resize is two small matrix products.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tpunet_torch.config import CIFAR10_CLASSES, DataConfig, ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict, load_state_dict_file


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of JAX's antialiased bilinear resize
    along one axis (``jax._src.image.scale.compute_weight_mat`` with the
    triangle kernel, scale n_out/n_in, no translation). Cached and
    shared between callers: do not modify."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - dist / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights_on(n_in: int, n_out: int,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_weights(n_in, n_out)).to(device)


@functools.lru_cache(maxsize=8)
def _norm_stats_on(mean: Tuple[float, ...], std: Tuple[float, ...],
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[H, W, C] float32 -> [size, size, C], as ``jax.image.resize(x,
    (size, size, C), "bilinear")``; an axis already of ``size`` is left
    untouched, as JAX skips it."""
    h, w = x.shape[0], x.shape[1]
    if h != size:
        x = torch.einsum("hwc,hH->Hwc", x, _resize_weights_on(h, size, x.device))
    if w != size:
        x = torch.einsum("hwc,wW->hWc", x, _resize_weights_on(w, size, x.device))
    return x


def to_uint8(image) -> np.ndarray:
    """PIL image, uint8 array, or float array in [0, 1] or [0, 255] ->
    uint8 HWC RGB array (the JAX Predictor's input coercion)."""
    if hasattr(image, "convert"):      # PIL image
        image = np.asarray(image.convert("RGB"))
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image * 255 if image.max() <= 1.0 else image,
                        0, 255).astype(np.uint8)
    return image


def preprocess(image_u8: np.ndarray, data_cfg: DataConfig,
               device) -> torch.Tensor:
    """uint8 [H, W, 3] -> normalized float32 [S, S, 3], computed on
    ``device``. On the card the upload is asynchronous (from pinned
    memory), so the calling thread does not wait for work already
    queued on the stream."""
    device = torch.device(device)
    x = torch.tensor(image_u8)  # copies: PIL arrays are read-only
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    x = x.float() / 255.0
    x = resize_bilinear(x, data_cfg.image_size)
    mean, std = _norm_stats_on(tuple(data_cfg.mean), tuple(data_cfg.std),
                               device)
    return (x - mean) / std


@dataclasses.dataclass
class PredictionResult:
    predicted: str               # class name, or "uncertain"
    confidence: float
    uncertain: bool
    topk: List[Tuple[str, float]]


class Predictor:
    """Holds a classifier's weights on ``device`` and serves top-k
    predictions; any model of ``ModelConfig``.

    Weights come from ``state_dict`` (the port's layout, e.g.
    :func:`tpunet_torch.models.convert.state_dict_from_jax` or
    :func:`~tpunet_torch.models.convert.vit_state_dict_from_jax`), or from
    the ``.pth`` file ``checkpoint``, or else from the seeded init."""

    def __init__(self,
                 model_cfg: Optional[ModelConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 state_dict: Optional[Mapping] = None,
                 checkpoint: Optional[str] = None,
                 device: str = "cuda",
                 class_names: Sequence[str] = CIFAR10_CLASSES):
        self.model_cfg = model_cfg or ModelConfig()
        self.data_cfg = data_cfg or DataConfig()
        self.device = torch.device(device)
        self.class_names = tuple(class_names)
        self.model = create_model(self.model_cfg, device=device,
                                  image_size=self.data_cfg.image_size)
        if state_dict is not None:
            load_state_dict(self.model, state_dict)
        elif checkpoint:
            load_state_dict_file(checkpoint, self.model)

    @torch.inference_mode()
    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """Normalized float32 images [B, S, S, 3] -> class probabilities
        [B, num_classes] (float32, on the model's device)."""
        x = batch.to(self.device).permute(0, 3, 1, 2)  # channels_last NCHW
        return torch.softmax(self.model(x), dim=-1)

    def predict_probs(self, image) -> np.ndarray:
        """image: (H, W, 3) uint8 array or PIL.Image; returns class probs."""
        x = preprocess(to_uint8(image), self.data_cfg, self.device)
        return self.forward(x[None])[0].cpu().numpy()

    def predict(self, image, topk: int = 3,
                conf_threshold: float = 0.5) -> PredictionResult:
        probs = self.predict_probs(image)
        order = np.argsort(probs)[::-1][:topk]
        top = [(self.class_names[i], float(probs[i])) for i in order]
        best_name, best_conf = top[0]
        uncertain = best_conf < conf_threshold
        return PredictionResult(
            predicted="uncertain" if uncertain else best_name,
            confidence=best_conf,
            uncertain=uncertain,
            topk=top,
        )


def add_model_args(p) -> None:
    """The model flags of the serving CLIs, with tpunet's names."""
    p.add_argument("--model", default="mobilenet_v2",
                   choices=["mobilenet_v2", "vit", "vit_tiny", "vit_small",
                            "vit_base"])
    p.add_argument("--width-mult", type=float, default=None,
                   help="MobileNetV2 width multiplier")
    p.add_argument("--vit-patch", type=int, default=None)
    p.add_argument("--vit-hidden", type=int, default=None)
    p.add_argument("--vit-depth", type=int, default=None)
    p.add_argument("--vit-heads", type=int, default=None)
    p.add_argument("--vit-mlp-ratio", type=float, default=None)
    p.add_argument("--attention", default=None,
                   choices=["auto", "dense", "blockwise", "flash"],
                   help="ViT attention core (auto = the flash kernels)")


def model_config(args, **kw) -> ModelConfig:
    """The ModelConfig of :func:`add_model_args`' flags (those not given
    keep their defaults)."""
    for name in ("width_mult", "vit_patch", "vit_hidden", "vit_depth",
                 "vit_heads", "vit_mlp_ratio", "attention"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    return ModelConfig(name=args.model, **kw)


def main(argv=None):
    import argparse

    from PIL import Image

    p = argparse.ArgumentParser(description="tpunet_torch top-k inference")
    p.add_argument("image", help="path to an image file")
    p.add_argument("--checkpoint", required=True,
                   help=".pth in the port's layout (a trainer's best.pth)")
    add_model_args(p)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default="cuda")
    p.add_argument("--topk", type=int, default=3)
    p.add_argument("--conf-threshold", type=float, default=0.5)
    args = p.parse_args(argv)
    pred = Predictor(model_config(args, num_classes=args.num_classes),
                     DataConfig(image_size=args.image_size,
                                num_classes=args.num_classes),
                     checkpoint=args.checkpoint, device=args.device)
    result = pred.predict(Image.open(args.image), topk=args.topk,
                          conf_threshold=args.conf_threshold)
    print(f"Predicted: {result.predicted} "
          f"(confidence {result.confidence:.4f})")
    for name, prob in result.topk:
        print(f"  {name}: {prob:.4f}")


if __name__ == "__main__":
    main()
