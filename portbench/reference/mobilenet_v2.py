"""MobileNetV2 (Sandler et al., arXiv:1801.04381, Table 2; torchvision's
``mobilenet_v2``), written out plainly for the reference: the training
forward over a dict of parameters in torchvision's state-dict names,
float32, with train-mode batch normalisation over the whole batch.

``cast`` is called where the port keeps a tensor in its activation
dtype (:mod:`portbench.reference.precision`). Each inverted-residual
block runs under ``torch.utils.checkpoint``, so a batch of several
hundred images at 224 px fits beside nothing else on one card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

# (expansion t, output channels c, repeats n, first stride s): Table 2.
SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
BN_EPS = 1e-5
HEAD = 1280


def _divisible(v: float, d: int = 8) -> int:
    new = max(d, int(v + d / 2) // d * d)
    return new + d if new < 0.9 * v else new


def blocks(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(cin, cout, stride, expansion) of the 17 inverted residuals."""
    w = cfg["width_mult"]
    cin, out = _divisible(32 * w), []
    for t, c, n, s in SETTINGS:
        cout = _divisible(c * w)
        for i in range(n):
            out.append((cin, cout, s if i == 0 else 1, t))
            cin = cout
    return out


def _stem(cfg: dict) -> int:
    return _divisible(32 * cfg["width_mult"])


def _head(cfg: dict) -> int:
    return _divisible(HEAD * max(1.0, cfg["width_mult"]))


def param_spec(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every parameter; std 0 is a zero, -1 a one.
    torchvision's initialisation: kaiming-normal convolutions (fan out),
    N(0, 0.01) classifier, unit and zero batch-norm affines."""
    spec: List[Tuple[str, tuple, float]] = []

    def conv(name, o, i, k):
        spec.append((name, (o, i, k, k), (2.0 / (o * k * k)) ** 0.5))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), -1.0),
                     (f"{name}.bias", (c,), 0.0)])

    c0 = _stem(cfg)
    conv("features.0.0.weight", c0, 3, 3)
    bn("features.0.1", c0)
    for b, (cin, cout, _, t) in enumerate(blocks(cfg), start=1):
        hid, p, u = cin * t, f"features.{b}.conv", 0
        if t != 1:
            conv(f"{p}.0.0.weight", hid, cin, 1)
            bn(f"{p}.0.1", hid)
            u = 1
        conv(f"{p}.{u}.0.weight", hid, 1, 3)
        bn(f"{p}.{u}.1", hid)
        conv(f"{p}.{u + 1}.weight", cout, hid, 1)
        bn(f"{p}.{u + 2}", cout)
    last = len(blocks(cfg)) + 1
    conv(f"features.{last}.0.weight", _head(cfg), blocks(cfg)[-1][1], 1)
    bn(f"features.{last}.1", _head(cfg))
    spec.extend([("classifier.1.weight", (cfg["num_classes"], _head(cfg)),
                  0.01),
                 ("classifier.1.bias", (cfg["num_classes"],), 0.0)])
    return spec


def draw(generator: torch.Generator, n: int, cfg: dict,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's draws after the augmentation's: the dropout's uniform
    [n, 1280] on the step generator (the host's), for the global batch."""
    if cfg["dropout_rate"] <= 0:
        return {}
    return {"u": torch.rand((n, _head(cfg)), generator=generator,
                            device=generator.device)}


def _bn_act(x, w, b, act: bool, cast: Callable) -> torch.Tensor:
    xf = x.float()
    y = F.batch_norm(xf, None, None, w, b, training=True, eps=BN_EPS)
    if act:
        y = torch.clamp(y, 0.0, 6.0)
    return cast(y)


def _unit(P, prefix, x, stride, groups, act, cast):
    w = P[f"{prefix}.0.weight"]
    y = cast(F.conv2d(x, cast(w), stride=stride, padding=w.shape[-1] // 2,
                      groups=groups))
    return _bn_act(y, P[f"{prefix}.1.weight"], P[f"{prefix}.1.bias"], act,
                   cast)


def _block(P, b, cin, cout, stride, t, cast, x):
    p, u, y = f"features.{b}.conv", 0, x
    if t != 1:
        y = _unit(P, f"{p}.0", y, 1, 1, True, cast)
        u = 1
    y = _unit(P, f"{p}.{u}", y, stride, cin * t, True, cast)
    y = cast(F.conv2d(y, cast(P[f"{p}.{u + 1}.weight"])))
    y = _bn_act(y, P[f"{p}.{u + 2}.weight"], P[f"{p}.{u + 2}.bias"], False,
                cast)
    return cast(y + x) if stride == 1 and cin == cout else y


def forward(P: Dict[str, torch.Tensor], x: torch.Tensor,
            rand: Dict[str, torch.Tensor], cast: Callable,
            cfg: dict) -> torch.Tensor:
    """Float32 logits [B, classes] of normalised images [B,S,S,3]."""
    x = cast(x.permute(0, 3, 1, 2).contiguous())
    x = _unit(P, "features.0", x, 2, 1, True, cast)
    for b, (cin, cout, stride, t) in enumerate(blocks(cfg), start=1):
        x = torch.utils.checkpoint.checkpoint(
            _block, P, b, cin, cout, stride, t, cast, x, use_reentrant=False)
    x = _unit(P, f"features.{len(blocks(cfg)) + 1}", x, 1, 1, True, cast)
    x = cast(x.mean(dim=(2, 3)))
    rate = cfg["dropout_rate"]
    if rate > 0:
        keep = rand["u"].to(x.device) < 1.0 - rate
        x = cast(torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)))
    return cast(F.linear(x, cast(P["classifier.1.weight"]),
                         cast(P["classifier.1.bias"]))).float()


def train_flops_per_sample(cfg: dict, image_size: int) -> float:
    """The port's ``train_flops_per_unit`` for MobileNetV2, copied: the
    published 0.30 GMACs of an inference at width 1.0 and 224 px, scaled
    by the pixels and the square of the width, times two FLOPs a MAC and
    three for the forward and the backward."""
    scale = (image_size / 224.0) ** 2 * cfg["width_mult"] ** 2
    return 3.0 * 2.0 * 0.30e9 * scale


def op_calls(cfg: dict, batch: int, image_size: int) -> Dict[str, list]:
    """The hand-kernel ops of one training step of one rank, by family,
    at the layers' shapes: ``depthwise`` (n, h, w, c, stride) for the 17
    depthwise 3x3 convolutions; ``fused_ir`` (m, ci, co) for the 33
    stride-1 expand and project 1x1 convolutions with their batch norm
    (the stem's and the head's stay library calls)."""
    h = -(-image_size // 2)                      # after the stem
    dw, fused = [], []
    for cin, cout, stride, t in blocks(cfg):
        hid = cin * t
        if t != 1:
            fused.append((batch * h * h, cin, hid))
        dw.append((batch, h, h, hid, stride))
        h = (h - 1) // stride + 1
        fused.append((batch * h * h, hid, cout))
    return {"depthwise": dw, "fused_ir": fused}
