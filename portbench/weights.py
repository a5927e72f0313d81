"""Seeded weights, made on the device.

The benchmark makes every parameter itself, from ``--seed`` and the
configuration's parameter list (the reference's ``param_spec``), and
hands the same values to the program and to the reference: one draw of
standard normals for all of them from a ``torch.Generator`` on the card,
scaled leaf by leaf; ones and zeros where the spec says so. Float32, the
type the configurations keep their parameters in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

WEIGHT_STREAM = 0x3E1


def make(spec: List[Tuple[str, tuple, float]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} of ``spec`` ((name, shape, std); std 0 is a
    zero, -1 a one) from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + WEIGHT_STREAM) % 2 ** 63)
    drawn = [(n, s, std) for n, s, std in spec if std > 0]
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, std in spec:
        if std > 0:
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape) * std
            off += k
        else:
            out[name] = torch.full(shape, 1.0 if std < 0 else 0.0,
                                   device=device)
    return out


def load_into(model: torch.nn.Module, values: Dict[str, torch.Tensor]):
    """Copy ``values`` into ``model``'s parameters, which must be exactly
    the same names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(values):
        raise ValueError(
            f"the configuration's parameters differ from the program's: "
            f"only in the program {sorted(set(params) - set(values))[:5]}, "
            f"only in the spec {sorted(set(values) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            v = values[name]
            if tuple(p.shape) != tuple(v.shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, spec "
                                 f"{tuple(v.shape)}")
            p.copy_(v)
