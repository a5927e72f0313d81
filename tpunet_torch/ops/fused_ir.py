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
  tpunet leaves them to XLA. Under data parallelism the statistics are
  those of the global batch, as tpunet's psum under batch sharding
  gives them (``fused_ir.py:364,414``): the forward's column sums and
  the backward's two reductions are summed over the ranks
  (``tpunet_torch.parallel.all_reduce``) before they are used, and the
  row count is the global one; the kernels do not change.

Activations are the NHWC tensor as a matrix ``[M = N*H*W, C]``. Dispatch
is by device only: a CPU tensor runs the plain version, a CUDA tensor
launches the hand-written kernels (``tpunet_torch/csrc/fused_ir.cu``)
or raises. No shape is sent to the plain version: every call on the card
launches the kernels.

The kernels replace the Pallas TPU kernels ``tpunet/ops/fused_ir.py``
``_fwd_kernel`` (the forward) and ``_bwd_kernel`` (the backward). Which
kernel serves which type is chosen by type alone, in the C entries:

- bfloat16 (the main path): tensor-core kernels, ``mma.sync`` m16n8k16
  with float32 accumulators, fed by ``ldmatrix`` and 16-byte ``cp.async``
  (element copies for odd widths and unaligned views). Bytes bound them
  at MobileNetV2's widths (8 to 240 operations a byte, below the ~295 at
  which the H100's bf16 tensor cores would), so the designs read each
  operand once: the forward's persistent blocks cover Co in n8 blocks up
  to 96 columns and keep their column sums in registers; the backward
  rebuilds the float32 ``t`` as two bf16 terms (``t_hi + t_lo``, two
  products each, since one bf16 rounding of ``t`` would fail the
  gates), in one pass over x, g and y where dw fits a block's registers
  (the 112, 56 and 28 px layers but the 28 px expand), else as a dx
  kernel and a split-K dw kernel, after a kernel that writes ``t`` once
  where Ci > 128 (the 14 px projects and the 7 px layers).
  :func:`forward_plan` and :func:`backward_plan` say how a call is cut;
  the choice among these hand-written kernels is by shape, and no shape
  goes to torch.
- float32: the SIMT kernels (64x64 tiles, ``fmaf`` on the CUDA cores).

No kernel sums with float atomics: two launches give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from tpunet_torch.ops import _build
from tpunet_torch.ops.depthwise import _DTYPE_CODES, _sm_count
from tpunet_torch.parallel.dist import all_reduce
from tpunet_torch.parallel.mesh import axis_group, axis_size



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


# Rows of a tile in every kernel (4 warps x 16 rows in the bf16 ones).
_ROWS = 64
# float32 SIMT kernels: 64x64 output tiles, k in steps of 16.
_SIMT_TILE = 64
_SIMT_STEP = 16
# bf16 kernels (csrc/fused_ir.cu): cp.async stages of the pipelined loops,
# the forward's widest strip (12 n8 blocks), the one-pass dw tiles a
# block holds (12 a warp), the wide kernels' dx strip and dw tile, and
# their dw rows a stage.
_STAGES = 3
_FWD_STRIP = 96
_FWD_WHOLE_K = 192   # Ci (padded) staged whole at most, w resident
_ONE_PASS_TILES = 48
_WIDE_TILE = 64
_DW_ROWS = 32
# Blocks an SM: the bf16 kernels take up to ~160 registers a thread, so 3
# blocks of 128 threads, fewer where shared memory runs out; the SIMT
# ones as before.
_BLOCKS_PER_SM = 3
_MAX_SMEM = 232448   # dynamic shared memory a block may take
_SM_BYTES = 233472   # shared memory of an SM, 1 KB of it reserved a block
_GRID_Y = 65535


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _r16(v: int) -> int:
    return _ceil(v, 16) * 16


def _per_sm(smem: int) -> int:
    return max(1, min(_BLOCKS_PER_SM, _SM_BYTES // (smem + 1024)))


@dataclass(frozen=True)
class ForwardPlan:
    """How the forward kernel cuts y = x.w: ``strips`` strips of
    ``strip`` output columns by ``blocks`` blocks along the rows; block b
    of a strip takes the ``tile_rows``-row tiles b, b + blocks, ... with
    k in chunks of ``k_chunk`` and writes one float32 [2, Co] partial of
    the column sums (``partials`` = ``blocks``, ``scratch_bytes`` of
    them). ``design``: "mma", the bf16 tensor-core kernel, or "simt",
    the float32 one; ``smem_bytes``: its dynamic shared memory."""
    design: str
    tile_rows: int
    strip: int
    strips: int
    k_chunk: int
    blocks: int
    partials: int
    scratch_bytes: int
    smem_bytes: int


@dataclass(frozen=True)
class BackwardPlan:
    """How the backward kernels cut one call.

    ``design``:
    - "one_pass" (bf16, dw fits a block's registers): ``blocks`` blocks
      each walk the ``tile_rows``-row tiles b, b + blocks, ... (``span``
      = ``tile_rows``), write dx for those tiles (all Ci, ``strip`` =
      Ci padded to 16) and one float32 [Ci, Co] dw partial;
    - "two_kernel" (bf16): dx by ``tile_rows``-row tiles x ``strip``-wide
      Ci strips; dw by 64x64 (Ci, Co) tiles x ``partials`` spans of
      ``span`` rows (``blocks`` dw blocks in all), one partial a span;
      each kernel rebuilds t from g and y;
    - "t_first" (bf16): as "two_kernel", after a kernel that takes
      ``t_rows`` rows at a time has written t_hi and t_lo (``t_bytes``),
      which the two then read in place of g and y;
    - "simt" (float32): as "two_kernel", on the SIMT kernels.

    ``scratch_bytes``: the dw partials; ``smem_bytes``: dynamic shared
    memory of a one-pass block (0 for the others). ``dx_rows``: the rows
    one dx launch takes; the tile-indexed designs put row tiles on grid
    y, so they launch dx over ranges of at most 65535 tiles, and the
    one-pass design (persistent blocks over any number of tiles) takes
    all ``m`` in one launch."""
    design: str
    tile_rows: int
    strip: int
    blocks: int
    partials: int
    span: int
    scratch_bytes: int
    smem_bytes: int
    t_rows: int
    t_bytes: int
    dx_rows: int


_BWD_DESIGNS = {"simt": 0, "one_pass": 1, "two_kernel": 2, "t_first": 3}


def forward_smem(ci: int, strip: int, k_chunk: int) -> int:
    """Dynamic shared memory of a bf16 forward block (as
    ``csrc/fused_ir.cu:fwd_smem``)."""
    cip, ns = _r16(ci), strip // 8
    ldw = _ceil(ns, 2) * 16 + 8
    wrows = cip if k_chunk >= cip else _STAGES * k_chunk
    return ((_STAGES * _ROWS * (k_chunk + 8) + wrows * ldw
             + _ROWS * (strip + 8)) * 2 + 128 * 16 * 4)


def _forward_chunk(cip: int, strip: int, strips: int) -> int:
    """k a forward step takes (it divides Ci padded to 16, so every step
    is the same). All of Ci where it is at most 192 and two blocks an SM
    still fit: w then stays resident and a tile is one step, which the
    card ran fastest at large M. Else 32 for strips of 96 columns or 4
    strips or more, 64 for the others: on the card the wide layers ran
    fastest with these, trading blocks an SM against steps."""
    if cip <= _FWD_WHOLE_K and _per_sm(forward_smem(cip, strip, cip)) >= 2:
        return cip
    k = 32 if strip >= _FWD_STRIP or strips >= 4 else 64
    while cip % k:
        k //= 2
    return k


def forward_plan(m: int, ci: int, co: int, dtype: torch.dtype, sms: int
                 ) -> ForwardPlan:
    """The forward's tiles for x [m, ci] and w [ci, co] of ``dtype`` on a
    card of ``sms`` SMs. bf16: strips of whole n8 blocks, as few as cover
    Co at up to 96 columns, evened out (Co = 144 gives two of 72), k in
    equal chunks (:func:`_forward_chunk`), and as many blocks along the rows as the SMs hold
    at once (the blocks are persistent). float32: 64-column strips and
    about 8 blocks an SM."""
    tiles = _ceil(m, _ROWS)
    if dtype == torch.bfloat16:
        strips = _ceil(co, _FWD_STRIP)
        strip = _ceil(_ceil(co, 8), strips) * 8
        strips = _ceil(co, strip)
        k_chunk = _forward_chunk(_r16(ci), strip, strips)
        smem = forward_smem(ci, strip, k_chunk)
        blocks = _ceil(_per_sm(smem) * sms, strips)
        design = "mma"
    else:
        strip, k_chunk, smem = _SIMT_TILE, _SIMT_STEP, 0
        strips = _ceil(co, strip)
        blocks = _ceil(8 * sms, strips)
        design = "simt"
    blocks = max(1, min(tiles, blocks, _GRID_Y))
    return ForwardPlan(design, _ROWS, strip, strips, k_chunk, blocks, blocks,
                       blocks * 2 * co * 4, smem)


def one_pass_smem(ci: int, co: int) -> int:
    """Dynamic shared memory of a one-pass backward block (as
    ``csrc/fused_ir.cu:one_pass_smem``): two stages of x, g and y tiles,
    w, the dx tile, chan and the warps' dw tile table, rows padded by 8
    elements."""
    cip, cop = _r16(ci), _r16(co)
    return ((3 * _ROWS * (cip + 8) + 4 * _ROWS * (cop + 8) + cip * (cop + 8))
            * 2 + 6 * cop * 4 + 4 * 12 * 8)


def backward_plan(m: int, ci: int, co: int, dtype: torch.dtype, sms: int
                  ) -> BackwardPlan:
    """The backward's tiles for x [m, ci] and g, y [m, co] of ``dtype``
    on a card of ``sms`` SMs. The float32 scratch of the dw partials,
    partials*Ci*Co*4 bytes, never exceeds a quarter of the bytes of x and
    g (one partial at least).

    bf16 takes the one-pass kernel where its dw accumulator, (Ci/16) x
    (Co/8) m16 x n8 tiles with Ci and Co padded to 16, fits 48 tiles (12
    a warp) and two blocks an SM fit its shared memory, with as many
    blocks as the SMs hold at once (on the card one block an SM, at 28 px
    32 -> 192, ran slower than the two kernels). Else the dx and
    dw kernels, with the dw split aiming at 4 blocks an SM: they rebuild
    t themselves where Ci is at most two 64-column tiles ("two_kernel"),
    else t is written once first ("t_first"), since each kernel would
    rebuild it once per 64 columns of Ci. float32 takes the SIMT
    kernels."""
    elem = 2 if dtype == torch.bfloat16 else 4
    cap = max(1, m * (ci + co) * elem // 4 // (ci * co * 4))
    tiles = _ceil(m, _ROWS)
    cip, cop = _r16(ci), _r16(co)
    if (dtype == torch.bfloat16
            and (cip // 16) * (cop // 8) <= _ONE_PASS_TILES
            and _per_sm(one_pass_smem(ci, co)) >= 2):
        smem = one_pass_smem(ci, co)
        blocks = max(1, min(tiles, cap, _per_sm(smem) * sms))
        return BackwardPlan("one_pass", _ROWS, cip, blocks, blocks, _ROWS,
                            blocks * ci * co * 4, smem, 0, 0, m)
    if dtype == torch.bfloat16:
        step, per_sm = _DW_ROWS, 4
        design = ("two_kernel" if _ceil(ci, _WIDE_TILE) <= 2 else "t_first")
    else:
        design, step, per_sm = "simt", _SIMT_STEP, 4
    dw_tiles = _ceil(ci, _WIDE_TILE) * _ceil(co, _WIDE_TILE)
    p = max(1, min(_ceil(per_sm * sms, dw_tiles), cap, _ceil(m, step),
                   _GRID_Y))
    span = _ceil(_ceil(m, p), step) * step
    p = _ceil(m, span)
    t_rows = t_bytes = 0
    if design == "t_first":
        t_rows = max(1, min(m, 2048 * sms // (co // 8 if co % 8 == 0 else co)))
        t_bytes = 2 * m * co * 2
    return BackwardPlan(design, _ROWS, _WIDE_TILE, dw_tiles * p, p, span,
                        p * ci * co * 4, 0, t_rows, t_bytes,
                        min(tiles, _GRID_Y) * _ROWS)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = _build.load("fused_ir")
    fwd, bwd = lib.tpunet_fused_ir_fwd, lib.tpunet_fused_ir_bwd
    fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64]
                    + [ctypes.c_int] * 5 + [ctypes.c_int64]
                    + [ctypes.c_int, ctypes.c_int64, ctypes.c_int]
                    + [ctypes.c_void_p])
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
    plan = forward_plan(m, ci, co, x.dtype, _sm_count(x.device.index or 0))
    y = torch.empty((m, co), dtype=x.dtype, device=x.device)
    part = torch.empty((plan.partials, 2, co), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[0](x.data_ptr(), w.data_ptr(), y.data_ptr(),
                            part.data_ptr(), m, ci, co, plan.blocks,
                            plan.strip, plan.k_chunk, _DTYPE_CODES[x.dtype],
                            _stream(x))
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
    if x.numel() >= 2**31 or g.numel() >= 2**31:
        raise ValueError("fused_ir_backward: 2^31 elements or more")
    # Each design bounds its own launches by its grid (BackwardPlan).
    plan = backward_plan(m, ci, co, x.dtype, _sm_count(x.device.index or 0))
    dx = torch.empty_like(x)
    dwp = torch.empty((plan.partials, ci, co), dtype=torch.float32,
                      device=x.device)
    tbuf = (torch.empty((2, m, co), dtype=x.dtype, device=x.device)
            if plan.t_bytes else None)
    with torch.cuda.device(x.device):
        err = _kernels()[1](x.data_ptr(), g.data_ptr(), y.data_ptr(),
                            w.data_ptr(), chan.data_ptr(), dx.data_ptr(),
                            dwp.data_ptr(),
                            None if tbuf is None else tbuf.data_ptr(),
                            m, ci, co, int(act), _BWD_DESIGNS[plan.design],
                            plan.partials, plan.span, plan.t_rows,
                            plan.dx_rows, _DTYPE_CODES[x.dtype], _stream(x))
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


def bn_act_epilogue(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, act: bool,
                    eps: float) -> Tuple[torch.Tensor, ...]:
    """The BN (+ReLU6) epilogue of the conv output ``y`` [M, Co] with the
    batch statistics: ``(out in y.dtype, r = rsqrt(var + eps), inv,
    shift)``. :class:`Conv1x1BNActFunction` runs it, and block remat
    calls it again to recompute ``out`` to the bit."""
    r = torch.rsqrt(var + eps)
    inv = r * scale.float()
    shift = bias.float() - mean * inv
    o = y.float() * inv + shift
    if act:
        o = torch.clamp(o, 0.0, 6.0)
    return o.to(y.dtype), r, inv, shift


class Conv1x1BNActFunction(torch.autograd.Function):
    """Fused 1x1 conv + train-mode BN (+ReLU6), the counterpart of
    tpunet's ``_fused`` custom_vjp: kernel forward, then the statistics
    and epilogue in torch; in the backward, the two batch reductions in
    torch, then the kernel. The column sums and the two reductions are
    summed over the ranks, and divided by the global row count."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, act, eps):
        n, h, wd, ci = x.shape
        co = w.shape[1]
        m = n * h * wd
        x2 = x.reshape(m, ci)
        y, s = fused_ir_forward(x2, w)
        s = all_reduce(s, axis_group("data"))
        m = m * axis_size("data")
        mean = s[0] / m
        var = torch.clamp_min(s[1] / m - mean * mean, 0.0)
        o, r, inv, shift = bn_act_epilogue(y, mean, var, scale, bias, act,
                                           eps)
        ctx.act = act
        ctx.save_for_backward(x2, w, y, inv, shift, r, mean * r)
        ctx.mark_non_differentiable(mean, var, y)
        ctx.dtypes = (x.shape, scale.dtype, bias.dtype)
        ctx.rows = m
        return o.view(n, h, wd, co), mean, var, y

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var, _g_y):
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
        r1 = gm.sum(dim=0)            # = dbias (this rank's rows)
        r2 = (gm * yh).sum(dim=0)     # = dscale (this rank's rows)
        # dx sees the whole batch's reductions: rank r's rows feed every
        # rank's outputs through the global statistics.
        rr = all_reduce(torch.stack([r1, r2]), axis_group("data"))
        chan = torch.stack([inv, shift, r, mr, rr[0] / ctx.rows,
                            rr[1] / ctx.rows])
        dx, dw = fused_ir_backward(x2, g2, y, w, chan, ctx.act)
        return (dx.view(x_shape), dw.to(w.dtype), r2.to(scale_dtype),
                r1.to(bias_dtype), None, None)


def conv1x1_bn_act(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, act: bool = True, eps: float = 1e-5,
                   return_conv: bool = False) -> Tuple[torch.Tensor, ...]:
    """Fused train-mode 1x1 conv + BN statistics + scale/shift (+ReLU6):
    ``x`` [N,H,W,Ci] (contiguous NHWC), ``w`` [Ci,Co] of the same dtype,
    ``scale``/``bias`` the BN affine parameters -> ``(out [N,H,W,Co] in
    x.dtype, batch_mean, batch_var)`` float32; mean and var carry no
    gradient. ``return_conv`` appends the conv output y [N*H*W, Co]
    (no gradient), from which block remat recomputes ``out``."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"conv1x1_bn_act: x must be a contiguous "
                         f"[N,H,W,Ci], got {list(x.shape)}")
    out = Conv1x1BNActFunction.apply(x, w, scale, bias, act, eps)
    return out if return_conv else out[:3]

