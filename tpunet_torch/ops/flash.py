"""Flash attention: the three hand-written kernels and their plain versions.

Port of ``tpunet/ops/flash.py``. BTHD layout throughout: q [B,Tq,H,D],
k and v [B,Tk,H,D], float32 or bfloat16, head dim 16, 32, 64 or 128.

- :func:`flash_attention_forward`: online-softmax attention, optionally
  with the log-sum-exp ``lse`` [B,H,Tq] float32 that the backward needs
  (tpunet's ``_pallas_forward`` / ``_pallas_forward_res``);
- :func:`flash_attention_dq` and :func:`flash_attention_dkv`: the two
  backward kernels (tpunet's ``_pallas_backward``), recomputing the
  probabilities from ``lse``, with ``delta = rowsum(dO * O)`` computed in
  float32 torch and an optional ``glse``, the cotangent of ``lse``;
- :class:`FlashAttentionFunction` joins them as the counterpart of
  tpunet's ``_make_flash`` custom_vjp: its forward saves (q, k, v, out,
  lse); :func:`flash_attention`, :func:`local_flash_attention` and
  :func:`local_flash_attention_state` are the public entries, and
  :func:`merge_attention_states` combines two partial states exactly.

Every function keeps tpunet's masks and conventions: scores formed in
float32 from the operands, times ``scale`` (default D^-1/2); causal
masking ``qpos + (tk - tq) >= kpos``; optional ``segment_ids`` (q_seg
[B,Tq], kv_seg [B,Tk]) for packed sequences; masked scores are -1e30 and
their probabilities 0, so a query with no key gives 0 and lse -1e30.

Dispatch is by device only: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel (``tpunet_torch/csrc/flash.cu``) or
raises. Which kernel is chosen by type inside the library:

- bfloat16, all three: tensor-core kernels (``mma.sync`` bf16 products
  with float32 sums, tiles brought in by 16-byte ``cp.async``, p and ds
  kept in registers between the products; each output is summed by the
  one block that owns it, in a fixed order, so two runs give the same
  bits). Bytes set their
  least time at ViT's shapes, so the design reads each operand once,
  keeps the next tile's loads in flight, keeps the elementwise work lean
  (the card shows them bound by instruction issue) and skips the parts
  of the ragged last tile that lie past T. Their 16-byte copies need a
  bf16 operand's data pointer and batch/token/head strides to be
  multiples of 16 bytes; :func:`_check` raises otherwise (the views
  ``qkv.unbind(2)`` of a fused projection pass);
- float32, all three: SIMT kernels that stage tiles as float32 and
  multiply on the CUDA cores, summing in the plain versions' order (dQ
  and dK/dV equal them bit for bit at ViT's shapes).

The kernels tile queries and keys by 64 whatever ``block_q`` and
``block_k`` say (those are the TPU kernel's block sizes, accepted for
tpunet's signature), and the plain forward steps through keys in the
same tiles of :data:`KERNEL_BLOCK`, so that p is rounded to the input
type against the same running max on both sides. Not carried over:
``custom_partitioning`` (the port runs on one device), the triangular
grids (a block skips the tiles its causal mask hides), and the dense
fallbacks for degenerate lengths and off-TPU (the kernel takes any T).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tpunet_torch.ops import _build
from tpunet_torch.ops.attention import _NEG_INF, SegmentIds, attention_mask

KERNEL_BLOCK = 64      # the kernels' query and key tile (csrc/flash.cu kBlock)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """[B,H,Tq,Tk] float32 scores, the product rounded before the scale."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def flash_attention_forward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = False, scale: Optional[float] = None,
        segment_ids: SegmentIds = None, block_k: int = KERNEL_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: ``(out [B,Tq,H,D] in q.dtype, lse
    [B,H,Tq] float32)``, the TPU kernel's online softmax over key tiles
    of ``block_k``: running max, normaliser and float32 accumulator, p
    rounded to v's type before p.V."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, tq, h, d = q.shape
    tk = k.shape[1]
    m = torch.full((b, h, tq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq, 1), device=q.device)
    acc = torch.zeros((b, h, tq, d), device=q.device)
    mask = attention_mask(tq, tk, causal, segment_ids, q.device)
    for j in range(0, tk, block_k):
        s = _scores(q, k[:, j:j + block_k], scale)
        mj = None if mask is None else mask[:, None, :, j:j + block_k]
        if mj is not None:
            s = torch.where(mj, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if mj is not None:
            # Fully masked rows keep m at the floor, where exp(s - m) is
            # 1: zero the masked probabilities explicitly.
            p = torch.where(mj, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                          v[:, j:j + block_k].float())
        acc = acc * corr + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype).transpose(1, 2).contiguous()
    lse = torch.where(l == 0.0, _NEG_INF, m + torch.log(l_safe))
    return out, lse[..., 0]


def _p_ds(q, k, v, do, lse, delta, glse, causal, scale, segment_ids):
    """Shared backward math (tpunet's ``_recompute_p_ds``): p = exp(s -
    lse) masked, ds = p * (dO.Vᵀ - delta + glse) * scale, all float32
    [B,H,Tq,Tk]."""
    s = _scores(q, k, scale)
    mask = attention_mask(q.shape[1], k.shape[1], causal, segment_ids,
                          q.device)
    if mask is not None:
        s = torch.where(mask[:, None], s, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask[:, None], p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    g = dp - delta[..., None]
    if glse is not None:
        g = g + glse[..., None]
    return p, p * g * scale


def flash_attention_dq_reference(q, k, v, do, lse, delta, *,
                                 causal: bool = False,
                                 scale: Optional[float] = None,
                                 segment_ids: SegmentIds = None,
                                 glse: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain version of dQ: ``ds.K`` with ds rounded to k's type,
    float32 sums, contiguous [B,Tq,H,D] in q.dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds = _p_ds(q, k, v, do, lse, delta, glse, causal, scale, segment_ids)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                        k.float()).to(q.dtype).contiguous()


def flash_attention_dkv_reference(q, k, v, do, lse, delta, *,
                                  causal: bool = False,
                                  scale: Optional[float] = None,
                                  segment_ids: SegmentIds = None,
                                  glse: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of dK/dV: ``(dsᵀ.Q in k.dtype, pᵀ.dO in v.dtype)``
    with ds rounded to q's type and p to dO's, float32 sums."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    p, ds = _p_ds(q, k, v, do, lse, delta, glse, causal, scale, segment_ids)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    # Contiguous [B,Tk,H,D], as the kernel writes them.
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------


def _misaligned(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels' 16-byte copies cannot read ``t``: a
    bfloat16 BTHD tensor whose data pointer, or whose batch, token or
    head stride along a dim longer than 1, is not a multiple of 16
    bytes."""
    if t.dtype != torch.bfloat16:
        return False
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 != 0
            or any(s % step for s, n in zip(t.stride()[:3], t.shape[:3])
                   if n > 1))


def _check(name: str, q, k, v, segment_ids, do=None, rows=()) -> None:
    """Raise on what the kernels do not take, on either device."""
    tensors = [q, k, v] + ([do] if do is not None else [])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: q, k, v (and dO) must share a device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}; "
                         "all must be float32 or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be BTHD [B,T,H,D]")
    b, tq, h, d = q.shape
    if min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if do is not None and do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} is not one of {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: the head dim must be contiguous "
                         "(stride 1); batch, token and head strides are free")
    bad = [t for t in tensors if _misaligned(t)]
    if bad:
        raise ValueError(
            f"{name}: a bfloat16 operand's data pointer and batch, token "
            "and head strides must be multiples of 16 bytes (the kernels "
            "copy 16-byte chunks with cp.async); got strides "
            f"{[tuple(t.stride()) for t in bad]}")
    if b > 65535 or h > 65535:
        raise ValueError(f"{name}: batch {b} or heads {h} above 65535")
    for r in rows:
        if r is None:
            continue
        if (r.dtype != torch.float32 or tuple(r.shape) != (b, h, tq)
                or r.device != q.device):
            raise ValueError(f"{name}: lse/delta/glse must be float32 "
                             f"[B,H,Tq] = {[b, h, tq]} on {q.device}, got "
                             f"{r.dtype} {list(r.shape)} on {r.device}")
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        if (tuple(q_seg.shape) != (b, tq) or tuple(kv_seg.shape)
                != (b, k.shape[1]) or q_seg.device != q.device
                or kv_seg.device != q.device
                or q_seg.is_floating_point() or kv_seg.is_floating_point()):
            raise ValueError(f"{name}: segment_ids must be integer [B,Tq], "
                             f"[B,Tk] on {q.device}")


def _strides(*tensors) -> ctypes.Array:
    """The batch, token and head element strides of 4 BTHD tensors (the
    forward repeats v for the unused dO slot)."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * 12)(*vals)


def _segs(segment_ids: SegmentIds):
    """int32 contiguous copies of the segment ids, or (None, None)."""
    if segment_ids is None:
        return None, None
    return tuple(s.to(torch.int32).contiguous() for s in segment_ids)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry ``name`` of ``csrc/flash.cu``, built, loaded and bound
    once."""
    fn = getattr(_build.load("flash"), name)
    # Pointers: q, k, v, (qseg, kseg, o, lse) or (dout, lse, delta,
    # glse, qseg, kseg, dq | dk, dv); then the strides array.
    pointers = {"tpunet_flash_fwd": 7, "tpunet_flash_bwd_dq": 10,
                "tpunet_flash_bwd_dkv": 11}[name]
    fn.argtypes = ([ctypes.c_void_p] * pointers
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call(name: str, wrapper, q: torch.Tensor, args, strides, tk: int,
          scale: float, causal: bool) -> None:
    """Launch the C entry ``name``, raise on its error code, and count the
    launch in ``wrapper.launches``."""
    b, tq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _entry(name)(*args, strides, b, h, tq, tk, d, scale,
                           int(causal), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    wrapper.launches += 1


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            scale: Optional[float] = None,
                            segment_ids: SegmentIds = None,
                            with_lse: bool = False):
    """Attention forward: ``out`` [B,Tq,H,D] in q.dtype, or ``(out,
    lse)`` with ``with_lse`` (lse [B,H,Tq] float32, -1e30 on rows that
    attend to nothing).

    On a CUDA tensor it launches the hand-written kernel and counts the
    launch in ``flash_attention_forward.launches``; on a CPU tensor it
    runs the plain version."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check("flash_attention_forward", q, k, v, segment_ids)
    if q.device.type == "cpu":
        out, lse = flash_attention_forward_reference(
            q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
        return (out, lse) if with_lse else out
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    qs, ks = _segs(segment_ids)
    _call("tpunet_flash_fwd", flash_attention_forward, q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qs), _ptr(ks),
           out.data_ptr(), _ptr(lse)),
          _strides(q, k, v, v), k.shape[1], scale, causal)
    return (out, lse) if with_lse else out


flash_attention_forward.launches = 0


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                       scale: Optional[float] = None,
                       segment_ids: SegmentIds = None,
                       glse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dQ [B,Tq,H,D] in q.dtype from the forward's ``lse``, ``delta =
    rowsum(dO * O)`` and the optional ``glse`` (each [B,H,Tq] float32).

    On a CUDA tensor it launches the hand-written kernel and counts the
    launch in ``flash_attention_dq.launches``; on a CPU tensor it runs
    the plain version."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check("flash_attention_dq", q, k, v, segment_ids, do,
           (lse, delta, glse))
    if q.device.type == "cpu":
        return flash_attention_dq_reference(
            q, k, v, do, lse, delta, causal=causal, scale=scale,
            segment_ids=segment_ids, glse=glse)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    qs, ks = _segs(segment_ids)
    rows = [r.contiguous() if r is not None else None
            for r in (lse, delta, glse)]
    _call("tpunet_flash_bwd_dq", flash_attention_dq, q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           *map(_ptr, rows), _ptr(qs), _ptr(ks), dq.data_ptr()),
          _strides(q, k, v, do), k.shape[1], scale, causal)
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                        scale: Optional[float] = None,
                        segment_ids: SegmentIds = None,
                        glse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Tk,H,D] in k's and v's dtype, from the same inputs as
    :func:`flash_attention_dq`.

    On a CUDA tensor it launches the hand-written kernel and counts the
    launch in ``flash_attention_dkv.launches``; on a CPU tensor it runs
    the plain version."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check("flash_attention_dkv", q, k, v, segment_ids, do,
           (lse, delta, glse))
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(
            q, k, v, do, lse, delta, causal=causal, scale=scale,
            segment_ids=segment_ids, glse=glse)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    qs, ks = _segs(segment_ids)
    rows = [r.contiguous() if r is not None else None
            for r in (lse, delta, glse)]
    _call("tpunet_flash_bwd_dkv", flash_attention_dkv, q,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           *map(_ptr, rows), _ptr(qs), _ptr(ks), dk.data_ptr(),
           dv.data_ptr()),
          _strides(q, k, v, do), k.shape[1], scale, causal)
    return dk, dv


flash_attention_dkv.launches = 0


# ---------------------------------------------------------------------------
# Autograd and the public entries
# ---------------------------------------------------------------------------


class FlashAttentionFunction(torch.autograd.Function):
    """(out, lse) = attention(q, k, v) with the flash backward; the
    counterpart of tpunet's ``_make_flash`` custom_vjp, and of
    ``_flash_local_state`` when lse is consumed (its cotangent is the
    ``glse`` of the backward kernels; None when lse is unused)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_seg, kv_seg):
        seg = None if q_seg is None else (q_seg, kv_seg)
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           scale=scale, segment_ids=seg,
                                           with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        seg = None if q_seg is None else (q_seg, kv_seg)
        if g_out is None:
            g_out = torch.zeros_like(out)
        elif g_out.stride(-1) != 1 or _misaligned(g_out):
            # The kernels read d contiguous, and bf16 in 16-byte chunks.
            g_out = g_out.clone(memory_format=torch.contiguous_format)
        # delta = rowsum(dO * O) in float32, [B,H,Tq] (tpunet's :508).
        delta = (out.float() * g_out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        glse = None if g_lse is None else g_lse.float().contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale, segment_ids=seg,
                  glse=glse)
        dq = flash_attention_dq(q, k, v, g_out, lse, delta, **kw)
        dk, dv = flash_attention_dkv(q, k, v, g_out, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_blocks(block_q: int, block_k: int) -> None:
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block_q {block_q} and block_k {block_k} must be "
                         ">= 1")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512,
                    segment_ids: SegmentIds = None) -> torch.Tensor:
    """Fused flash attention, BTHD layout, a drop-in for
    ``dense_attention``. Differentiable: under autograd the forward keeps
    lse and the backward runs the dQ and dK/dV kernels; without autograd
    (serving) the forward writes no lse. ``block_q``/``block_k`` are
    tpunet's TPU block sizes, checked and otherwise not read (the kernels
    tile by 64). ``segment_ids``: optional (q_seg [B,Tq], kv_seg [B,Tk])
    integer pair for packed sequences."""
    _check_blocks(block_q, block_k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        q_seg, kv_seg = segment_ids if segment_ids is not None else (None,
                                                                     None)
        out, _ = FlashAttentionFunction.apply(q, k, v, causal, scale, q_seg,
                                              kv_seg)
        return out
    return flash_attention_forward(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segment_ids)


def local_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = False,
                          scale: Optional[float] = None,
                          block_q: int = 512, block_k: int = 512,
                          segment_ids: SegmentIds = None) -> torch.Tensor:
    """tpunet's entry for per-shard arrays inside ``shard_map``; on one
    device it is :func:`flash_attention`."""
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           block_q=block_q, block_k=block_k,
                           segment_ids=segment_ids)


def local_flash_attention_state(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = False,
                                scale: Optional[float] = None,
                                block_q: int = 512, block_k: int = 512
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,Tq,H,D], lse [B,H,Tq]) over one K/V block, the ring's
    core; both outputs are differentiable (lse's cotangent reaches the
    backward kernels as ``glse``)."""
    _check_blocks(block_q, block_k)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, scale, None,
                                            None)
    return flash_attention_forward(q, k, v, causal=causal, scale=scale,
                                   with_lse=True)


def merge_attention_states(state_a, state_b):
    """Exactly combine two partial attention results over disjoint K/V
    blocks; each state is (out [B,Tq,H,D] normalised, lse [B,H,Tq]).
    With m = max(lse_a, lse_b) and w_x = exp(lse_x - m): out = (w_a*out_a
    + w_b*out_b) / (w_a + w_b), lse = m + log(w_a + w_b). Rows dead in
    both (lse -1e30) give zeros and lse -1e30."""
    oa, la = state_a
    ob, lb = state_b
    m = torch.maximum(la, lb)
    both_dead = m <= _NEG_INF
    wa = torch.where(both_dead, 0.0, torch.exp(la - m))
    wb = torch.where(both_dead, 0.0, torch.exp(lb - m))
    denom = wa + wb
    safe = torch.where(denom == 0.0, 1.0, denom)

    def to_bthd(w):
        return w.transpose(1, 2)[..., None]

    out = (to_bthd(wa) * oa.float() + to_bthd(wb) * ob.float()) / to_bthd(safe)
    lse = torch.where(denom == 0.0, _NEG_INF, m + torch.log(safe))
    return out.to(oa.dtype), lse
