"""Configuration for the PyTorch port: the fields the ported slice honours.

A copy of the matching parts of ``tpunet/config.py`` with identical
defaults (the reference project's literals: 224 px, 10 classes,
ImageNet normalization, MobileNetV2 width 1.0 with dropout 0.2, bf16
activations over f32 parameters, classify micro-batching of 8 images in
a 2 ms window). Fields of the JAX config that no ported module reads
yet are left out rather than accepted and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# ImageNet normalization statistics: the reference trains with these,
# and serving reuses the training stats (one constant everywhere).
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)

CIFAR10_CLASSES: Tuple[str, ...] = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)

# Model names of the JAX package that the port does not build yet, and
# the ROADMAP item that ports them.
_NOT_PORTED = {
    "vit": "Queue A item 4 (ViT/LM with the flash trio)",
    "vit_tiny": "Queue A item 4 (ViT/LM with the flash trio)",
    "vit_small": "Queue A item 4 (ViT/LM with the flash trio)",
    "vit_base": "Queue A item 4 (ViT/LM with the flash trio)",
    "lm": "Queue A item 4 (ViT/LM with the flash trio)",
    "vit_pp": "Queue A item 8 (parallelism beyond DP)",
    "lm_pp": "Queue A item 8 (parallelism beyond DP)",
}


@dataclass(frozen=True)
class DataConfig:
    """Image size, class count and normalization of the served model."""

    image_size: int = 224
    num_classes: int = 10
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


@dataclass(frozen=True)
class ModelConfig:
    """MobileNetV2 config (torchvision's model with a 10-class head).

    ``use_pallas_depthwise`` keeps the JAX package's name: it routes the
    17 depthwise convs through the hand-written depthwise kernel
    (``tpunet_torch.ops.depthwise_conv3x3``) instead of ``F.conv2d``.
    ``fused_bn`` is carried for config parity: in eval mode both BN
    forms of the JAX package compute the same per-channel FMA + clamp,
    which is the only BN the port runs so far.
    """

    name: str = "mobilenet_v2"
    num_classes: int = 10
    width_mult: float = 1.0
    dropout_rate: float = 0.2
    use_pallas_depthwise: bool = False
    fused_bn: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.name in _NOT_PORTED:
            raise NotImplementedError(
                f"model {self.name!r} is not ported to tpunet_torch yet; "
                f"it comes with ROADMAP {_NOT_PORTED[self.name]}")
        if self.name != "mobilenet_v2":
            raise ValueError(f"unknown model {self.name!r}")


@dataclass(frozen=True)
class ServeConfig:
    """The classifier micro-batching fields of ``tpunet.config.ServeConfig``:
    hold a request at most ``classify_window_ms`` to coalesce up to
    ``classify_batch_max`` images into one batched forward."""

    classify_batch_max: int = 8
    classify_window_ms: float = 2.0
