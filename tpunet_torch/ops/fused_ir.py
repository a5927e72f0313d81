"""Fused inverted-residual 1x1 conv + train-mode BatchNorm (+ReLU6): kernels
and plain versions.

Port of ``tpunet/ops/fused_ir.py``. Train-mode MobileNetV2 sends the
expand and project 1x1 convs of every inverted residual here
(``ConvBN``'s routing when ``fused_ir`` is set):

- :func:`fused_ir_forward`: ``y = x.w`` with float32 accumulation, stored
  in ``x.dtype``, and the float32 column sums ``[sum(y), sum(y*y)]`` of
  the rounded ``y`` (the BN statistics without a second read of ``y``);
- :func:`fused_ir_backward`: from the saved ``x``, ``y``, ``w``, the
  output gradient ``g`` and the per-channel ``chan``, the input gradient
  ``dx = t.w^T`` and ``dw = x^T.t``, where ``t``, the gradient of the
  conv output, is rebuilt inside the kernel and never stored;
- :func:`conv1x1_bn_act`: the two as a ``torch.autograd.Function``
  returning ``(out, mean, var)``; ``mean`` and ``var`` feed only the
  running-statistics update and are not differentiable (tpunet's
  contract at ``fused_ir.py:387-391``). The (C,)-sized statistics, the
  epilogue and the backward's two batch reductions are plain torch, as
  tpunet leaves them to XLA.

Activations are the NHWC tensor as a matrix ``[M = N*H*W, C]``. Dispatch
is by device only: a CPU tensor runs the plain version, a CUDA tensor
launches the hand-written kernels (``tpunet_torch/csrc/fused_ir.cu``)
or raises. There is no per-shape rule: every call on the card launches
the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tpunet_torch.ops import _build
from tpunet_torch.ops.depthwise import _DTYPE_CODES, _sm_count

_TILE = 64     # rows and columns of a block's output tile (csrc/fused_ir.cu)
_STEP = 16     # the kernels' step along the summed dimension


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_ir_forward_reference(x: torch.Tensor, w: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [M,Co] in x.dtype, s [2,Co] float32)``: the product in float32,
    rounded to ``x.dtype``, and the sums of the rounded ``y`` and its
    square over the rows."""
    y = (x.float() @ w.float()).to(x.dtype)
    yb = y.float()
    return y, torch.stack([yb.sum(dim=0), (yb * yb).sum(dim=0)])


def grad_conv_out(g: torch.Tensor, y: torch.Tensor, chan: torch.Tensor,
                  act: bool) -> torch.Tensor:
    """``t = inv * (gm - r1/n - yh * r2/n)``, the gradient of the conv
    output, in float32 (``chan`` rows: inv, shift, r, mr, r1/n, r2/n)."""
    inv, shift, r, mr, e, f = chan
    yf, gm = y.float(), g.float()
    if act:
        yn = yf * inv + shift
        gm = gm * ((yn > 0.0) & (yn < 6.0)).float()
    yh = yf * r - mr
    return inv * (gm - e - yh * f)


def fused_ir_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                y: torch.Tensor, w: torch.Tensor,
                                chan: torch.Tensor, act: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx [M,Ci] in x.dtype, dw [Ci,Co] float32)``, with ``x`` and ``w``
    taken to float32 for both products, as the TPU kernel does."""
    t = grad_conv_out(g, y, chan, act)
    return (t @ w.float().t()).to(x.dtype), x.float().t() @ t


def conv1x1_bn_act_reference(x: torch.Tensor, w: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             act: bool, eps: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(out, batch_mean, batch_var)`` of ``x`` [N,H,W,Ci] and ``w``
    [Ci,Co] under autograd, op for op tpunet's
    ``conv1x1_bn_act_reference`` (FusedBNAct's train math)."""
    y = torch.einsum("nhwc,cd->nhwd", x, w)
    yf = y.float()
    mean = yf.mean(dim=(0, 1, 2))
    var = torch.clamp_min((yf * yf).mean(dim=(0, 1, 2)) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps) * scale.float()
    shift = bias.float() - mean * inv
    o = yf * inv + shift
    if act:
        o = torch.clamp(o, 0.0, 6.0)
    return o.to(y.dtype), mean, var


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"{name}: x {x.dtype} and w {w.dtype}; both must "
                         "be float32 or both bfloat16")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or min(x.shape) < 1 or w.shape[1] < 1:
        raise ValueError(f"{name}: x must be [M,Ci] and w [Ci,Co], got "
                         f"{list(x.shape)} and {list(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")


def forward_splits(m: int, co: int, sms: int) -> int:
    """Blocks along the rows of the forward: about 8 blocks per SM, each
    walking a span of 64-row tiles, one [2,Co] partial each."""
    tiles = -(-m // _TILE)
    return max(1, min(tiles, -(-8 * sms // -(-co // _TILE))))


def backward_splits(m: int, ci: int, co: int, itemsize: int, sms: int
                    ) -> Tuple[int, int]:
    """``(p, span)`` of the dw product: ``p`` spans of ``span`` rows, one
    float32 [Ci,Co] partial each. About 4 blocks per SM, but the p*Ci*Co*4
    bytes of scratch never exceed a quarter of the bytes of x and g."""
    tiles = -(-ci // _TILE) * -(-co // _TILE)
    cap = max(1, m * (ci + co) * itemsize // 4 // (ci * co * 4))
    p = max(1, min(-(-4 * sms // tiles), cap, -(-m // _STEP)))
    span = -(-(-(-m // p)) // _STEP) * _STEP
    return -(-m // span), span


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("fused_ir")
    fwd, bwd = lib.tpunet_fused_ir_fwd, lib.tpunet_fused_ir_bwd
    fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                    + [ctypes.c_int] * 4 + [ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_void_p])
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ir_forward(x: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` [M,Ci] @ ``w`` [Ci,Co] -> ``(y [M,Co] in x.dtype, s [2,Co]
    float32 = [sum(y), sum(y*y)] of the rounded y)``.

    On a CUDA tensor it launches the hand-written kernel and counts the
    launch in ``fused_ir_forward.launches``; on a CPU tensor it runs the
    plain version."""
    _check("fused_ir_forward", x, w)
    if x.device.type == "cpu":
        return fused_ir_forward_reference(x, w)
    if x.numel() >= 2**31 or x.shape[0] * w.shape[1] >= 2**31:
        raise ValueError("fused_ir_forward: 2^31 elements or more")
    m, ci = x.shape
    co = w.shape[1]
    p = forward_splits(m, co, _sm_count(x.device.index or 0))
    y = torch.empty((m, co), dtype=x.dtype, device=x.device)
    part = torch.empty((p, 2, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[0](x.data_ptr(), w.data_ptr(), y.data_ptr(),
                            part.data_ptr(), m, ci, co, p,
                            _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_ir_forward: kernel launch failed with "
                           f"CUDA error {err}")
    fused_ir_forward.launches += 1
    return y, part.sum(dim=0)


fused_ir_forward.launches = 0


def fused_ir_backward(x: torch.Tensor, g: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor, chan: torch.Tensor, act: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx [M,Ci] in x.dtype, dw [Ci,Co] float32)`` from the saved ``x``
    [M,Ci], ``y`` [M,Co], ``w`` [Ci,Co], the output gradient ``g`` [M,Co]
    and ``chan`` [6,Co] float32 = [inv, shift, r, mr, r1/n, r2/n].

    On a CUDA tensor it launches the hand-written kernels (dx and the dw
    partials, one call) and counts the call in
    ``fused_ir_backward.launches``; on a CPU tensor it runs the plain
    version."""
    _check("fused_ir_backward", x, w)
    m, co = x.shape[0], w.shape[1]
    for name, t in (("g", g), ("y", y)):
        if t.shape != (m, co) or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"fused_ir_backward: {name} must be a "
                             f"contiguous [{m},{co}] {x.dtype} tensor on "
                             f"{x.device}")
    if chan.shape != (6, co) or chan.dtype != torch.float32 \
            or chan.device != x.device or not chan.is_contiguous():
        raise ValueError(f"fused_ir_backward: chan must be a contiguous "
                         f"[6,{co}] float32 tensor on {x.device}")
    if x.device.type == "cpu":
        return fused_ir_backward_reference(x, g, y, w, chan, act)
    ci = x.shape[1]
    if x.numel() >= 2**31 or g.numel() >= 2**31 or -(-m // _TILE) > 65535:
        raise ValueError("fused_ir_backward: too many rows for the grid")
    p, span = backward_splits(m, ci, co, x.element_size(),
                              _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dwp = torch.empty((p, ci, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[1](x.data_ptr(), g.data_ptr(), y.data_ptr(),
                            w.data_ptr(), chan.data_ptr(), dx.data_ptr(),
                            dwp.data_ptr(), m, ci, co, int(act), p, span,
                            _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"fused_ir_backward: kernel launch failed with "
                           f"CUDA error {err}")
    fused_ir_backward.launches += 1
    return dx, dwp.sum(dim=0)


fused_ir_backward.launches = 0

# Output gradients that autograd handed over in another layout than NHWC
# and that were copied to it before the backward (see PERF.md).
grad_layout_copies = 0


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class Conv1x1BNActFunction(torch.autograd.Function):
    """Fused 1x1 conv + train-mode BN (+ReLU6), the counterpart of
    tpunet's ``_fused`` custom_vjp: kernel forward, then the statistics
    and epilogue in torch; in the backward, the two batch reductions in
    torch, then the kernel."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, act, eps):
        n, h, wd, ci = x.shape
        co = w.shape[1]
        m = n * h * wd
        x2 = x.reshape(m, ci)
        y, s = fused_ir_forward(x2, w)
        mean = s[0] / m
        var = torch.clamp_min(s[1] / m - mean * mean, 0.0)
        r = torch.rsqrt(var + eps)
        inv = r * scale.float()
        shift = bias.float() - mean * inv
        o = y.float() * inv + shift
        if act:
            o = torch.clamp(o, 0.0, 6.0)
        ctx.act = act
        ctx.save_for_backward(x2, w, y, inv, shift, r, mean * r)
        ctx.mark_non_differentiable(mean, var)
        ctx.dtypes = (x.shape, scale.dtype, bias.dtype)
        return o.to(y.dtype).view(n, h, wd, co), mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        global grad_layout_copies
        x2, w, y, inv, shift, r, mr = ctx.saved_tensors
        x_shape, scale_dtype, bias_dtype = ctx.dtypes
        m, co = y.shape
        if not g.is_contiguous():
            grad_layout_copies += 1
            g = g.contiguous()
        g2 = g.view(m, co)
        yf, gm = y.float(), g2.float()
        if ctx.act:
            yn = yf * inv + shift
            gm = gm * ((yn > 0.0) & (yn < 6.0)).float()
        yh = yf * r - mr
        r1 = gm.sum(dim=0)            # = dbias
        r2 = (gm * yh).sum(dim=0)     # = dscale
        chan = torch.stack([inv, shift, r, mr, r1 / m, r2 / m])
        dx, dw = fused_ir_backward(x2, g2, y, w, chan, ctx.act)
        return (dx.view(x_shape), dw.to(w.dtype), r2.to(scale_dtype),
                r1.to(bias_dtype), None, None)


def conv1x1_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, act: bool = True, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused train-mode 1x1 conv + BN statistics + scale/shift (+ReLU6):
    ``x`` [N,H,W,Ci] (contiguous NHWC), ``w`` [Ci,Co] of the same dtype,
    ``scale``/``bias`` the BN affine parameters -> ``(out [N,H,W,Co] in
    x.dtype, batch_mean, batch_var)`` float32; mean and var carry no
    gradient."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"conv1x1_bn_act: x must be a contiguous "
                         f"[N,H,W,Ci], got {list(x.shape)}")
    return Conv1x1BNActFunction.apply(x, w, scale, bias, act, eps)
