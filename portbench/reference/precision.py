"""Where the reference rounds: float32 (the reference itself) or a lower
precision (the control).

The reference models call ``cast(t)`` at every point where the port
keeps an activation or a weight in its activation dtype. The reference
passes :func:`exact` (float32 everywhere); the control passes
:func:`fp8`, the step below bfloat16 that a later change could take:
float8 e4m3 values forward and float8 e5m2 gradients backward, each
tensor scaled by its largest magnitude first, as float8 training does.
:func:`bf16` rounds at the same points to the configuration's own
precision: a second witness of what that precision alone does.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(t: torch.Tensor) -> torch.Tensor:
    return _Bf16.apply(t)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


CASTS = {"float32": exact, "bf16": bf16, "fp8": fp8}
