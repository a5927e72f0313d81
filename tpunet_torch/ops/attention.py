"""Attention in PyTorch, port of ``tpunet/ops/attention.py``: dense,
blockwise, ring and Ulysses (sequence-parallel).

Layout is [batch, seq, heads, head_dim] (BTHD) throughout. Scores are
formed in float32 from the operands (bf16 products are exact in f32),
masked scores are ``_NEG_INF`` (-1e30, not -inf), and a query row that
may attend to no key gives zeros, not uniform attention (tpunet's
``l == 0`` convention):

- :func:`dense_attention`: one softmax over the whole [Tq, Tk] scores;
- :func:`blockwise_attention`: the online softmax over K/V chunks of
  ``block_size`` (memory O(Tq * block_size)), the same function. Its
  fold (:func:`_block_update`, :func:`_init_carry`, :func:`_finalize`:
  running max ``m``, normaliser ``l`` and float32 accumulator ``acc``)
  is the one the ring's blockwise core uses;
- :func:`ring_attention` (Liu et al.'s ring attention): this rank's
  queries stay, the K/V blocks of the ranks of the mesh's 'seq' group
  come round a ring of neighbour hops (``parallel.dist.ring_pass``), and
  each arriving block is folded in. Core ``blockwise``: the fold above,
  with causal masks from global positions; core ``flash``: each block's
  ``local_flash_attention_state`` (the hand-written flash kernels on a
  CUDA tensor, their plain versions on a CPU one) merged into a float32
  carry by ``merge_attention_states``, the block's lse in the graph so
  that its cotangent reaches the backward kernels as ``glse``;
- :func:`ulysses_attention` (DeepSpeed-Ulysses): one all-to-all trades
  the sequence sharding for head sharding, the local core (flash or
  blockwise) runs over the whole sequence on this rank's heads, and the
  inverse all-to-all shards the sequence again;
- :func:`ring_self_attention` and :func:`ulysses_self_attention`, the
  entries the models use: tpunet's take global arrays and a mesh and
  wrap the bodies in ``shard_map``; here each rank holds its shard
  ([B, T/S, H, D], its positions ``r*T/S`` up) and the functions read
  the current mesh's 'seq' group (``tpunet_torch.parallel.mesh``).

Causal masking keeps key ``j`` for query ``i`` when ``i + (tk - tq) >=
j`` (the decode-window offset) on one device, and compares global
positions across a ring; ``segment_ids`` (q_seg [B,Tq], kv_seg [B,Tk])
keep only same-segment pairs. Differentiable end to end: autograd runs
through the ring's hops and the all-to-alls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpunet_torch.parallel.dist import all_gather, all_to_all, ring_pass
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size

_NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/grads NaN-free

SegmentIds = Optional[Tuple[torch.Tensor, torch.Tensor]]
Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def attention_mask(tq: int, tk: int, causal: bool, segment_ids: SegmentIds,
                   device) -> Optional[torch.Tensor]:
    """[B or 1, Tq, Tk] bool mask (True = attend), or None for no mask."""
    mask = None
    if causal:
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=device).tril(tk - tq)[None]
    if segment_ids is not None:
        q_seg, kv_seg = segment_ids
        seg = q_seg[:, :, None] == kv_seg[:, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    segment_ids: SegmentIds = None) -> torch.Tensor:
    """Plain softmax attention, float32 accumulation, BTHD layout."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(q.shape[1], k.shape[1], causal, segment_ids,
                          q.device)
    if mask is not None:
        s = torch.where(mask[:, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        # Rows with no valid key (tq > tk top rows, orphan segments) get
        # zeros, matching the l == 0 convention of the blockwise form.
        p = torch.where(mask.any(-1)[:, None, :, None], p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# The shared online-softmax fold
# ---------------------------------------------------------------------------


def _block_update(carry: Carry, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, scale: float,
                  mask: Optional[torch.Tensor]) -> Carry:
    """Fold one K/V block into the (m, l, acc) running softmax state.

    q [B,Tq,H,D]; k, v [B,Tk,H,D]; mask [B or 1, Tq, Tk] bool (True =
    attend) or None. m, l [B,H,Tq]; acc [B,Tq,H,D]. All state float32."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, None], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # Rows with nothing to attend to yet keep m at the floor, where
    # exp(s - m) is 1: zero the masked probabilities explicitly.
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask[:, None], p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = (acc * corr.transpose(1, 2)[..., None]
           + torch.einsum("bhqk,bkhd->bqhd", p, v.float()))
    return m_new, l, acc


def _init_carry(q: torch.Tensor) -> Carry:
    b, tq, h, d = q.shape
    m = torch.full((b, h, tq), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    acc = torch.zeros((b, tq, h, d), device=q.device)
    return m, l, acc


def _finalize(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    # l == 0 only for rows masked out of every block; emit zeros there.
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe.transpose(1, 2)[..., None]).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None,
                        segment_ids: SegmentIds = None) -> torch.Tensor:
    """Online-softmax attention over K/V chunks of ``block_size``: the
    same result as :func:`dense_attention` with O(Tq * block_size)
    score memory. ``tk`` must be a multiple of the block (tpunet's
    rule); :func:`_divisor_block` picks one that is."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    tq, tk = q.shape[1], k.shape[1]
    block_size = min(block_size, tk)
    if tk % block_size != 0:
        raise ValueError(f"seq len {tk} not divisible by block {block_size}")
    q_pos = torch.arange(tq, device=q.device)
    carry = _init_carry(q)
    for j in range(0, tk, block_size):
        mask = None
        if causal:
            k_pos = j + torch.arange(block_size, device=q.device)
            mask = (q_pos[:, None] + (tk - tq) >= k_pos[None, :])[None]
        if segment_ids is not None:
            q_seg, kv_seg = segment_ids
            seg = q_seg[:, :, None] == kv_seg[:, None, j:j + block_size]
            mask = seg if mask is None else mask & seg
        carry = _block_update(carry, q, k[:, j:j + block_size],
                              v[:, j:j + block_size], scale, mask)
    return _finalize(*carry, q.dtype)


def _divisor_block(t: int, cap: int) -> int:
    """Largest divisor of ``t`` that is <= cap: honours explicitly tiny
    caps (the caller chose the block size on purpose)."""
    return next(b for b in range(min(cap, t), 0, -1) if t % b == 0)


def _auto_block(t: int, cap: int = 512) -> int:
    """Block size for a length-``t`` blockwise pass: the largest divisor
    of t that is <= ``cap``, bounding score memory to O(t x cap).
    Lengths whose only small divisors are degenerate (< 64, e.g. primes:
    a t-step loop of 1-wide blocks) take one dense pass instead."""
    if t <= cap:
        return t
    b = next(b for b in range(cap, 0, -1) if t % b == 0)
    return b if b >= 64 else t


# ---------------------------------------------------------------------------
# Ring attention (sequence-parallel over a mesh axis)
# ---------------------------------------------------------------------------


def _seq_axis(axis: str):
    """(group, size, this rank's index) of mesh axis ``axis``."""
    return axis_group(axis), axis_size(axis), axis_index(axis)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "seq", *, causal: bool = False,
                   scale: Optional[float] = None,
                   core: Optional[str] = None) -> torch.Tensor:
    """Sequence-parallel attention over the mesh axis ``axis_name``:
    q [B,Tq,H,D] and k, v [B,Tk,H,D] are this rank's shards (rank r of
    the axis holds queries ``r*Tq`` up and keys ``r*Tk`` up). The K/V
    blocks come round the ring (:func:`ring_pass`: n - 1 neighbour hops,
    none after the last block) and each is folded in: exactly
    :func:`dense_attention` of the gathered arrays, this rank's rows.

    ``core``: None or ``"flash"`` folds each block's flash state
    (:func:`_ring_flash`; None is tpunet's ``auto``, which on the card
    is the flash kernels), ``"blockwise"`` the plain online softmax.
    With None a causal ring whose Tq differs from Tk takes the
    blockwise core (its per-block masks are not the flash kernel's);
    ``core="flash"`` there raises, as tpunet's does.

    Autograd keeps every arriving K/V block for the backward: O(T) K/V
    a rank, as tpunet's scan keeps them."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group, n, my = _seq_axis(axis_name)
    tq, tk = q.shape[1], k.shape[1]
    auto = core is None
    if auto:
        core = "flash"
    if core not in ("flash", "blockwise"):
        raise ValueError(f"unknown attention core {core!r}")
    if core == "flash":
        if not causal or tq == tk:
            return _ring_flash(q, k, v, group, n, my, causal, scale)
        if not auto:
            raise ValueError(
                f"core='flash' does not support causal cross-length "
                f"rings (tq={tq} != tk={tk}: per-step masks are "
                "arbitrary); use core='blockwise'")
    blocks = ring_pass(torch.stack([k, v]), group)
    q_pos = my * tq + torch.arange(tq, device=q.device)
    carry = _init_carry(q)
    for step, kv in enumerate(blocks):
        mask = None
        if causal:
            # The block held at `step` came from rank (my - step) mod n.
            k_pos = (((my - step) % n) * tk
                     + torch.arange(tk, device=q.device))
            mask = (q_pos[:, None] >= k_pos[None, :])[None]
        carry = _block_update(carry, q, kv[0], kv[1], scale, mask)
    return _finalize(*carry, q.dtype)


def _ring_flash(q, k, v, group, n: int, my: int, causal: bool,
                scale: float) -> torch.Tensor:
    """The flash-core ring (see :func:`ring_attention`): each arriving
    block's ``(out, lse)`` from ``local_flash_attention_state``, merged
    exactly. Causal (Tq == Tk), each source shard is one of three cases:
    past (unmasked flash), the diagonal (causal flash) or future
    (skipped: no launch); tpunet's ``lax.cond`` on the source index is a
    Python branch here."""
    from tpunet_torch.ops.flash import (local_flash_attention_state,
                                        merge_attention_states)
    b, tq, h, d = q.shape
    # The merged output stays float32 across all n folds (the merge keeps
    # the carry's dtype) and is cast once at the end, as the blockwise
    # core's _finalize does: a q.dtype carry would re-round bf16 at every
    # step.
    state = (torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device),
             torch.full((b, h, tq), _NEG_INF, device=q.device))
    for step, kv in enumerate(ring_pass(torch.stack([k, v]), group)):
        src = (my - step) % n
        if causal and src > my:
            continue
        block = local_flash_attention_state(q, kv[0], kv[1],
                                            causal=causal and src == my,
                                            scale=scale)
        state = merge_attention_states(state, block)
    return state[0].to(q.dtype)


def _resolve_head_axis(head_axis: str, heads: int,
                       local_divisor: int = 1) -> Optional[str]:
    """The mesh axis that splits the heads, or None: tpunet's rule (the
    axis is above 1, divides ``heads`` and leaves a per-rank count
    divisible by ``local_divisor``). ``heads`` counts all of them; the
    port's Megatron blocks have already given each rank its ``heads /
    size`` of the axis."""
    size = axis_size(head_axis)
    if size <= 1 or heads % size or (heads // size) % local_divisor:
        return None
    return head_axis


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False, scale: Optional[float] = None,
                        core: Optional[str] = None) -> torch.Tensor:
    """tpunet's ``ring_self_attention`` on this rank's shard: q, k, v
    [B, T/S, H_local, D] (H_local the rank's heads under tensor
    parallelism, which the ring leaves alone: attention is elementwise
    in heads), the ring over the current mesh's 'seq' axis."""
    return ring_attention(q, k, v, "seq", causal=causal, scale=scale,
                          core=core)


# ---------------------------------------------------------------------------
# Ulysses attention (all-to-all sequence parallelism)
# ---------------------------------------------------------------------------


def _local_full_attention(q, k, v, causal: bool, scale: Optional[float],
                          core: Optional[str], block: Optional[int] = None,
                          segment_ids: SegmentIds = None) -> torch.Tensor:
    """The locally dense core over the whole sequence inside Ulysses:
    ``core`` None or ``"flash"`` the flash kernels (their plain versions
    on a CPU tensor; ``block`` is tpunet's TPU block size, checked and
    not read), ``"blockwise"`` the online softmax with ``block`` a cap
    clamped to a divisor of T (an explicit cap is honoured even below
    :func:`_auto_block`'s floor of 64)."""
    if core is None or core == "flash":
        from tpunet_torch.ops.flash import local_flash_attention
        b = block or 512
        return local_flash_attention(q, k, v, causal=causal, scale=scale,
                                     block_q=b, block_k=b,
                                     segment_ids=segment_ids)
    if core == "blockwise":
        bs = (_divisor_block(q.shape[1], block) if block
              else _auto_block(q.shape[1]))
        return blockwise_attention(q, k, v, block_size=bs, causal=causal,
                                   scale=scale, segment_ids=segment_ids)
    raise ValueError(f"unknown attention core {core!r}")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "seq", *, causal: bool = False,
                      scale: Optional[float] = None,
                      core: Optional[str] = None,
                      block: Optional[int] = None,
                      segment_ids: SegmentIds = None) -> torch.Tensor:
    """All-to-all sequence parallelism over the mesh axis ``axis_name``:
    q, k, v arrive as this rank's shards [B, T/S, H, D]; one all-to-all
    of the three stacked re-shards heads instead ([B, T, H/S, D]), the
    local core (``core``, :func:`_local_full_attention`) runs over the
    whole sequence, and the inverse all-to-all restores [B, T/S, H, D].
    Two collectives a call, at the cost of full-T activations for H/S
    heads.

    ``segment_ids`` (packed documents): a (q_seg, kv_seg) pair of this
    rank's [B, T/S] ids (equal: self-attention); one all-gather of the
    ids rebuilds the global [B, T] ids the core masks with."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"ulysses_attention is self-attention only (q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}); use ring_attention "
            "for cross-length attention")
    group, n, _ = _seq_axis(axis_name)
    if q.shape[2] % n:
        raise ValueError(
            f"{q.shape[2]} heads not divisible by sequence axis {n}")
    seg = None
    if segment_ids is not None:
        ids = segment_ids[0]     # self-attention: q_seg is kv_seg
        if n > 1:
            got = all_gather(ids, group)              # [n, B, T/S]
            ids = got.transpose(0, 1).reshape(ids.shape[0], -1)
        seg = (ids, ids)
    if n == 1:
        return _local_full_attention(q, k, v, causal, scale, core, block,
                                     segment_ids=seg)
    # [3, B, T/S, H, D] -> [3, B, T, H/S, D]: split heads, concat seq.
    qkv = all_to_all(torch.stack([q, k, v]), group, 3, 2)
    out = _local_full_attention(qkv[0], qkv[1], qkv[2], causal, scale, core,
                                block, segment_ids=seg)
    # [B, T, H/S, D] -> [B, T/S, H, D]: split seq, concat heads.
    return all_to_all(out, group, 1, 2)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = False,
                           scale: Optional[float] = None,
                           core: Optional[str] = None,
                           block: Optional[int] = None,
                           segment_ids: SegmentIds = None) -> torch.Tensor:
    """tpunet's ``ulysses_self_attention`` on this rank's shard: q, k, v
    [B, T/S, H_local, D], the all-to-alls over the current mesh's 'seq'
    axis. Under tensor parallelism over 'model' the rank holds ``H / M``
    heads already, and those must divide the sequence axis (tpunet's
    ``_resolve_head_axis(local_divisor=S)``)."""
    n, m = axis_size("seq"), axis_size("model")
    if m > 1 and _resolve_head_axis("model", q.shape[2] * m,
                                    local_divisor=n) is None:
        raise ValueError(
            f"{q.shape[2]} heads a rank of the 'model' axis not divisible "
            f"by sequence axis {n}")
    return ulysses_attention(q, k, v, "seq", causal=causal, scale=scale,
                             core=core, block=block,
                             segment_ids=segment_ids)
