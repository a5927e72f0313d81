"""3x3 depthwise convolution (NHWC, torch padding=1): kernel and plain version.

Port of ``tpunet/ops/depthwise.py`` (forward only; the backward pair
comes with the training slice). The public layout is the JAX one:
``x`` [N,H,W,C] and ``w`` [3,3,C] give [N,Ho,Wo,C]. A channels_last
NCHW activation is that NHWC tensor under ``permute(0, 2, 3, 1)``, with
no copy.

Dispatch is by device only: a CPU tensor goes to
:func:`depthwise_conv3x3_reference`, a CUDA tensor launches the
hand-written kernel (``tpunet_torch/csrc/depthwise.cu``) or raises.
"""

from __future__ import annotations

import ctypes
import functools

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
