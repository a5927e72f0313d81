"""3x3 depthwise convolution (NHWC, torch padding=1): kernels and plain versions.

Port of ``tpunet/ops/depthwise.py``: the forward
(:func:`depthwise_conv3x3`), the backward
(:func:`depthwise_conv3x3_backward`) and the two joined as a
``torch.autograd.Function`` (:func:`depthwise_conv3x3_train`, the
counterpart of tpunet's ``jax.custom_vjp``). The public layout is the
JAX one: ``x`` [N,H,W,C] and ``w`` [3,3,C] give [N,Ho,Wo,C]. A
channels_last NCHW activation is that NHWC tensor under
``permute(0, 2, 3, 1)``, with no copy.

Dispatch is by device only: a CPU tensor goes to the plain version, a
CUDA tensor launches the hand-written kernel
(``tpunet_torch/csrc/depthwise.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from tpunet_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _out_size(n: int, stride: int) -> int:
    return (n - 1) // stride + 1


def depthwise_conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                                stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version: pad by one pixel, sum the 9 shifted taps in
    float32 in the order (dy, dx), cast back to ``x.dtype`` — the
    kernel's arithmetic step for step."""
    n, h, wd, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (wo - 1) + 1:stride]
            acc = acc + tap * wf[dy, dx]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise_conv3x3: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"depthwise_conv3x3: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"depthwise_conv3x3: x {x.dtype} and w {w.dtype}; "
                         "both must be float32 or both bfloat16")
    if stride not in (1, 2):
        raise ValueError(f"depthwise_conv3x3: stride {stride} is not 1 or 2")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"depthwise_conv3x3: x must be a non-empty "
                         f"[N,H,W,C], got {tuple(x.shape)}")
    if tuple(w.shape) != (3, 3, x.shape[3]):
        raise ValueError(f"depthwise_conv3x3: w must be [3,3,{x.shape[3]}], "
                         f"got {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_conv3x3: x and w must be contiguous "
                         "(NHWC; a channels_last NCHW tensor permuted to "
                         "NHWC is)")
    if x.numel() >= 2**31:
        raise ValueError("depthwise_conv3x3: x holds 2^31 elements or more")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry of ``csrc/depthwise.cu``, built, loaded and bound once."""
    fn = _build.load("depthwise").tpunet_depthwise3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    fn = _kernel()
    n, h, wd, c = x.shape
    y = torch.empty((n, _out_size(h, stride), _out_size(wd, stride), c),
                    dtype=x.dtype, device=x.device)
    vectorised = c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, w, y))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c,
                 stride, _DTYPE_CODES[x.dtype], int(vectorised), stream)
    if err != 0:
        raise RuntimeError(f"depthwise_conv3x3: kernel launch failed with "
                           f"CUDA error {err}")
    depthwise_conv3x3.launches += 1
    return y


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
    """3x3 depthwise conv, NHWC, padding=1, stride 1 or 2.

    On a CUDA tensor it launches the hand-written kernel and counts the
    launch in ``depthwise_conv3x3.launches``; on a CPU tensor it runs
    the plain version. Inputs the kernel does not take raise on either
    device."""
    _check(x, w, stride)
    if x.device.type == "cpu":
        return depthwise_conv3x3_reference(x, w, stride)
    return _launch(x, w, stride)


depthwise_conv3x3.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


def depthwise_conv3x3_backward_reference(x: torch.Tensor, w: torch.Tensor,
                                         g: torch.Tensor, stride: int = 1
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``(dx, dw)`` with ``dx`` in
    ``x.dtype`` and ``dw`` the float32 sum (not yet cast).

    dx: each gradient tap ``g[i,j]*w[dy,dx]`` is added, in the order
    (dy, dx), into the padded input position ``(s*i+dy, s*j+dx)`` it came
    from — the kernel's arithmetic step for step. dw: per tap, the sum of
    the shifted padded input times g over batch and pixels."""
    n, h, wd, c = x.shape
    ho, wo = g.shape[1], g.shape[2]
    gf, wf = g.float(), w.float()
    accp = torch.zeros((n, h + 2, wd + 2, c), dtype=torch.float32,
                       device=x.device)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dw = torch.empty((3, 3, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            rows = slice(dy, dy + stride * (ho - 1) + 1, stride)
            cols = slice(dx, dx + stride * (wo - 1) + 1, stride)
            accp[:, rows, cols] += gf * wf[dy, dx]
            dw[dy, dx] = (xp[:, rows, cols] * gf).sum(dim=(0, 1, 2))
    # Contiguous NHWC, as the kernel writes it (the slice is a view).
    return accp[:, 1:h + 1, 1:wd + 1].to(x.dtype).contiguous(), dw


def _check_grad(x: torch.Tensor, g: torch.Tensor, stride: int) -> None:
    n, h, wd, c = x.shape
    want = (n, _out_size(h, stride), _out_size(wd, stride), c)
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"depthwise_conv3x3_backward: g is {g.dtype} on "
                         f"{g.device}, x is {x.dtype} on {x.device}")
    if tuple(g.shape) != want:
        raise ValueError(f"depthwise_conv3x3_backward: g must be {list(want)}, "
                         f"got {list(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("depthwise_conv3x3_backward: g must be contiguous "
                         "(NHWC)")


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    fn = _build.load("depthwise").tpunet_depthwise3x3_bwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def backward_grid(n: int, h: int, wd: int, c: int, sms: int
                  ) -> Tuple[int, int, int]:
    """(channel groups per block, blocks along the pixels, pixels per
    block) of the backward kernel: up to 32 groups of 8 channels across
    a block's 256 threads, and about 4 blocks per SM in all, so the dw
    partials number ``p`` and not one per pixel."""
    groups = -(-c // 8)
    tg = min(groups, 32)
    lanes = 256 // tg
    pixels = n * h * wd
    p = max(1, min(-(-pixels // lanes), -(-4 * sms // -(-groups // tg))))
    per_block = -(-pixels // p)
    return tg, -(-pixels // per_block), per_block


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _bwd_kernel()
    n, h, wd, c = x.shape
    tg, p, per_block = backward_grid(n, h, wd, c, _sm_count(x.device.index
                                                            or 0))
    dx = torch.empty_like(x)
    dwp = torch.empty((p, 3, 3, c), dtype=torch.float32, device=x.device)
    vectorised = c % 8 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (x, w, g, dx))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 dwp.data_ptr(), n, h, wd, c, stride, tg, p, per_block,
                 _DTYPE_CODES[x.dtype], int(vectorised), stream)
    if err != 0:
        raise RuntimeError(f"depthwise_conv3x3_backward: kernel launch "
                           f"failed with CUDA error {err}")
    depthwise_conv3x3_backward.launches += 1
    return dx, dwp.sum(dim=0)


def depthwise_conv3x3_backward(x: torch.Tensor, w: torch.Tensor,
                               g: torch.Tensor, stride: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of :func:`depthwise_conv3x3` for the output gradient
    ``g`` [N,Ho,Wo,C]: ``(dx [N,H,W,C] in x.dtype, dw [3,3,C] in
    w.dtype)``, dw accumulated in float32 (tpunet's
    ``jnp.sum(dwp, 0).astype(w.dtype)``).

    On a CUDA tensor it launches the hand-written kernel and counts the
    launch in ``depthwise_conv3x3_backward.launches``; on a CPU tensor
    it runs the plain version."""
    _check(x, w, stride)
    _check_grad(x, g, stride)
    if x.device.type == "cpu":
        dx, dw = depthwise_conv3x3_backward_reference(x, w, g, stride)
    else:
        dx, dw = _launch_bwd(x, w, g, stride)
    return dx, dw.to(w.dtype)


depthwise_conv3x3_backward.launches = 0

# Output gradients that autograd handed over in another layout than NHWC
# and that were copied to it before the backward (see PERF.md).
grad_layout_copies = 0


class DepthwiseConv3x3Function(torch.autograd.Function):
    """:func:`depthwise_conv3x3` with :func:`depthwise_conv3x3_backward`
    as its gradient; the counterpart of tpunet's ``jax.custom_vjp``."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return depthwise_conv3x3(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        global grad_layout_copies
        x, w = ctx.saved_tensors
        if not g.is_contiguous():
            grad_layout_copies += 1
            g = g.contiguous()
        dx, dw = depthwise_conv3x3_backward(x, w, g, ctx.stride)
        return dx, dw, None


def depthwise_conv3x3_train(x: torch.Tensor, w: torch.Tensor,
                            stride: int = 1) -> torch.Tensor:
    """Differentiable 3x3 depthwise conv (NHWC): kernel forward and
    kernel backward on the card, plain versions on the CPU."""
    return DepthwiseConv3x3Function.apply(x, w, stride)
