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
import math
from typing import NamedTuple, Tuple

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
    # Every call of the forward runs this, so each test is one of the
    # cheapest torch offers that still names what it refuses.
    if not (x.is_cuda or x.is_cpu):
        raise ValueError(f"depthwise_conv3x3: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError(f"depthwise_conv3x3: x on {x.device}, w on {w.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"depthwise_conv3x3: x {x.dtype} and w {w.dtype}; "
                         "both must be float32 or both bfloat16")
    if stride != 1 and stride != 2:
        raise ValueError(f"depthwise_conv3x3: stride {stride} is not 1 or 2")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"depthwise_conv3x3: x must be a non-empty "
                         f"[N,H,W,C], got {tuple(x.shape)}")
    if w.shape != (3, 3, x.shape[3]):
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
    """The C entry of ``csrc/depthwise.cu``, built, loaded and bound once,
    as a prototype call (cheaper a call than a library attribute with
    ``argtypes``)."""
    lib = _build.load("depthwise")
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * 4,
                             ctypes.c_int, ctypes.c_void_p)
    return proto(ctypes.cast(lib.tpunet_depthwise3x3_fwd,
                             ctypes.c_void_p).value)


class FwdCall(ctypes.Structure):
    """The C entry's ``FwdCall``: one call's shape and plan."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "h", "w", "c", "stride", "chunk", "rows", "threads", "blocks",
        "dtype")]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The forward's blocks hold two tiles of staged rows in at most 72 KB
# (three blocks an SM) or 110 KB (two an SM), with up to 256 threads (the
# kernel is compiled for 85 registers a thread, which three blocks of 256
# threads fit). A chunk spans at most 128 bytes of a pixel.
_FWD_STAGE_BYTES = {3: 72 * 1024, 2: 110 * 1024}
_FWD_THREADS = 256
_FWD_ROWS = 16
_FWD_CHUNK_BYTES = 128


class ForwardPlan(NamedTuple):
    """How the forward kernel cuts one call: tiles of ``rows`` output rows
    of one image (the whole width) by ``chunk`` channels, ``bands`` down
    an image and ``chunks`` across the channels, ``tiles`` in all (the
    chunk the fastest index, then the band, then the image). ``blocks``
    persistent blocks of ``threads`` threads, ``per_sm`` an SM, walk them
    with the grid's stride; a thread takes two channels and two
    neighbouring columns."""
    chunk: int
    rows: int
    threads: int
    bands: int
    chunks: int
    tiles: int
    blocks: int
    per_sm: int
    in_rows: int        # input rows a tile stages, with the halo
    in_cols: int        # and columns: the halo and whole column pairs
    stage_bytes: int    # shared memory of a block: two tiles' rows


def _in_rows(rows: int, stride: int) -> int:
    """Input rows that a band of ``rows`` output rows reaches, with the
    halo: one above and one below at stride 1, one above at stride 2."""
    return rows + 2 if stride == 1 else 2 * rows + 1


@functools.lru_cache(maxsize=None)
def forward_plan(n: int, h: int, wd: int, c: int, stride: int, elem: int,
                 sms: int) -> ForwardPlan:
    """The tiles and blocks of the forward kernel for x [n, h, wd, c] of
    ``elem`` bytes an element on a card of ``sms`` SMs, as
    ``csrc/depthwise.cu`` walks them.

    The chunk is the widest multiple of 8 channels of at most 128 bytes
    (one that divides C when C is a multiple of 8, the 16-byte path) for
    which two tiles of at least 4 output rows at stride 1 (1 at stride 2;
    or the whole image) fit 110 KB: narrower chunks read each pixel in
    more, smaller pieces, which the card's copy engine fetches more
    slowly. The band takes as many rows as fit 72 KB, up to 16, and three
    blocks an SM, if that is at least 7 rows at stride 1 (2 at stride 2;
    or the whole image); else as many as fit 110 KB, and two blocks an
    SM; evened out over the image. The threads: the multiple of 32 and of
    the chunk's channel pairs nearest 256 from below, or fewer if a band
    row has fewer (column pair, channel pair) items. The grid: that many
    blocks an SM, a multiple of the chunks, or the tiles if fewer."""
    ho, wo = _out_size(h, stride), _out_size(wd, stride)
    col_pairs = -(-wo // 2)
    in_cols = stride * 2 * col_pairs + 3 - stride

    def fit(chunk, per_sm):
        """The most rows, up to 16, of which two tiles fit the budget."""
        tile = in_cols * chunk * elem
        return max([r for r in range(1, min(ho, _FWD_ROWS) + 1)
                    if 2 * -(-_in_rows(r, stride) * tile // 128) * 128
                    <= _FWD_STAGE_BYTES[per_sm]], default=0)

    # Bands of fewer rows than these stage over 1.5 (for the chunk) or
    # 1.3 (for three blocks an SM) input rows for each one they read.
    least, enough = (4, 7) if stride == 1 else (1, 2)
    cands = [k for k in range(8, _FWD_CHUNK_BYTES // elem + 1, 8)
             if (c % k == 0 if c % 8 == 0 else k < c + 8)]
    chunk = cands[0]
    for cand in reversed(cands):
        if fit(cand, 2) >= min(ho, least):
            chunk = cand
            break
    rows, per_sm = fit(chunk, 3), 3
    if rows < min(ho, enough):
        rows, per_sm = max(1, fit(chunk, 2)), 2
    rows = -(-ho // -(-ho // rows))
    bands = -(-ho // rows)
    pairs = chunk // 2
    unit = pairs * 32 // math.gcd(pairs, 32)
    threads = max(unit, _FWD_THREADS // unit * unit)
    threads = min(threads, -(-col_pairs * pairs // unit) * unit)
    chunks = -(-c // chunk)
    tiles = n * bands * chunks
    blocks = min(tiles, max(1, per_sm * sms // chunks) * chunks)
    in_rows = _in_rows(rows, stride)
    return ForwardPlan(chunk, rows, threads, bands, chunks, tiles, blocks,
                       per_sm, in_rows, in_cols,
                       2 * -(-in_rows * in_cols * chunk * elem // 128) * 128)


@functools.lru_cache(maxsize=None)
def _call(n: int, h: int, wd: int, c: int, stride: int, dtype: torch.dtype,
          index: int):
    """The plan of a call, its ``FwdCall`` and that struct's address (the
    cache keeps the struct alive)."""
    plan = forward_plan(n, h, wd, c, stride, dtype.itemsize, _sm_count(index))
    call = FwdCall(n, h, wd, c, stride, plan.chunk, plan.rows, plan.threads,
                   plan.blocks, _DTYPE_CODES[dtype])
    return plan, call, ctypes.addressof(call)


def _launch(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    n, h, wd, c = x.shape
    index = x.get_device()
    plan, _, call = _call(n, h, wd, c, stride, x.dtype, index)
    y = x.new_empty((n, (h - 1) // stride + 1, (wd - 1) // stride + 1, c))
    xp, wp, yp = x.data_ptr(), w.data_ptr(), y.data_ptr()
    # The 16-byte path: whole 16-byte pieces of every pixel's channels,
    # and a tile's columns within one box of the copy engine (256).
    vectorised = int(c % 8 == 0 and plan.in_cols <= 256
                     and not (xp | wp | yp) & 15)
    if index == torch.cuda.current_device():
        err = _kernel()(xp, wp, yp, call, vectorised,
                        torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = _kernel()(xp, wp, yp, call, vectorised,
                            torch._C._cuda_getCurrentRawStream(index))
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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# Shared memory a backward block may stage its tile in, and its threads:
# four blocks an SM (the kernel is compiled for 128 registers a thread).
_BWD_STAGE_BYTES = 48 * 1024
_BWD_THREADS = 128
_BWD_ROWS = 16


class BackwardPlan(NamedTuple):
    """How the backward kernel cuts one call: blocks of ``rows`` input
    rows of one image (the whole width) by ``chunk`` channels, each run by
    ``threads`` threads that take two channels apiece; ``bands`` blocks
    down an image, ``chunks`` across the channels, and one float32 [9, C]
    dw partial per (image, band): ``partials`` in all."""
    chunk: int
    rows: int
    threads: int
    bands: int
    chunks: int
    grad_rows: int      # gradient rows a block stages (with the halo)
    stage_bytes: int    # shared memory its x and gradient rows take
    partials: int


def _grad_rows(rows: int, stride: int) -> int:
    """Gradient rows that a band of ``rows`` input rows reaches, with the
    halo: one above and one below at stride 1, one below at stride 2."""
    return rows + 2 if stride == 1 else rows // 2 + 1


def _stage_bytes(rows: int, wd: int, wo: int, chunk: int, stride: int,
                 elem: int) -> int:
    return ((_grad_rows(rows, stride) * (wo + 2) + rows * wd) * chunk
            * elem)


def backward_plan(n: int, h: int, wd: int, c: int, stride: int,
                  elem: int) -> BackwardPlan:
    """The tiles of the backward kernel for x [n, h, wd, c] of ``elem``
    bytes an element, as ``csrc/depthwise.cu`` walks them.

    A block stages its band's x rows and the gradient rows they reach in
    at most 48 KB. The chunk is the widest of 64, 32, 16 and 8 channels
    (one that divides C when C is a multiple of 8, the 16-byte path) that
    fits a band of at least 4 rows (or the whole image); the band then
    takes as many rows as fit, up to 16 (a multiple of the stride, so
    that every band starts on a row the stride divides), evened out over
    the image. As many threads as a band row has (column, channel pair)
    items, rounded up to a warp, at most 128."""
    wo = (wd - 1) // stride + 1
    top = min(h + h % stride, _BWD_ROWS)

    def fits(rows, chunk):
        return _stage_bytes(rows, wd, wo, chunk, stride,
                            elem) <= _BWD_STAGE_BYTES

    chunk, rows = 8, stride
    for cand in (64, 32, 16, 8):
        if cand > -(-c // 8) * 8 or (c % 8 == 0 and c % cand):
            continue
        if fits(min(top, 4), cand) or cand == 8:
            chunk = cand
            rows = max([r for r in range(stride, top + 1, stride)
                        if fits(r, cand)], default=stride)
            break
    rows = -(-h // -(-h // rows))
    rows += rows % stride
    bands = -(-h // rows)
    threads = min(_BWD_THREADS, -(-(wd * chunk // 2) // 32) * 32)
    return BackwardPlan(chunk, rows, threads, bands, -(-c // chunk),
                        _grad_rows(rows, stride),
                        _stage_bytes(rows, wd, wo, chunk, stride, elem),
                        n * bands)


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _bwd_kernel()
    n, h, wd, c = x.shape
    plan = backward_plan(n, h, wd, c, stride, x.element_size())
    dx = torch.empty_like(x)
    part = torch.empty((plan.partials, 9, c), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((3, 3, c), dtype=w.dtype, device=x.device)
    vectorised = c % 8 == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (x, w, g, dx))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(), n, h, wd, c, stride,
                 plan.chunk, plan.rows, plan.threads, _DTYPE_CODES[x.dtype],
                 int(vectorised), stream)
    if err != 0:
        raise RuntimeError(f"depthwise_conv3x3_backward: kernel launch "
                           f"failed with CUDA error {err}")
    depthwise_conv3x3_backward.launches += 1
    return dx, dw


def depthwise_conv3x3_backward(x: torch.Tensor, w: torch.Tensor,
                               g: torch.Tensor, stride: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of :func:`depthwise_conv3x3` for the output gradient
    ``g`` [N,Ho,Wo,C]: ``(dx [N,H,W,C] in x.dtype, dw [3,3,C] in
    w.dtype)``, dw accumulated in float32 (tpunet's
    ``jnp.sum(dwp, 0).astype(w.dtype)``).

    On a CUDA tensor it launches the hand-written kernel, which also sums
    dw's partials and casts them on the card in a fixed order, and counts
    the call in ``depthwise_conv3x3_backward.launches``; on a CPU tensor
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
