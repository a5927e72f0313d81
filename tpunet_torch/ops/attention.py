"""Plain attention in PyTorch, port of ``tpunet/ops/attention.py``.

Layout is [batch, seq, heads, head_dim] (BTHD) throughout. Scores are
formed in float32 from the operands (bf16 products are exact in f32),
masked scores are ``_NEG_INF`` (-1e30, not -inf), and a query row that
may attend to no key gives zeros, not uniform attention (tpunet's
``l == 0`` convention):

- :func:`dense_attention`: one softmax over the whole [Tq, Tk] scores;
- :func:`blockwise_attention`: the online softmax over K/V chunks of
  ``block_size`` (memory O(Tq * block_size)), the same function.

Causal masking keeps key ``j`` for query ``i`` when ``i + (tk - tq) >=
j`` (the decode-window offset), and ``segment_ids`` (q_seg [B,Tq],
kv_seg [B,Tk]) keep only same-segment pairs. The sequence-parallel ring
and Ulysses attentions wait for ROADMAP Queue A item 8 and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: keeps exp()/grads NaN-free

SegmentIds = Optional[Tuple[torch.Tensor, torch.Tensor]]


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


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None,
                        segment_ids: SegmentIds = None) -> torch.Tensor:
    """Online-softmax attention over K/V chunks of ``block_size``: the
    same result as :func:`dense_attention` with O(Tq * block_size)
    score memory. ``tk`` must be a multiple of the block (tpunet's
    rule); :func:`_divisor_block` picks one that is."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    block_size = min(block_size, tk)
    if tk % block_size != 0:
        raise ValueError(f"seq len {tk} not divisible by block {block_size}")
    qf = q.float()
    m = torch.full((b, h, tq), _NEG_INF, device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    q_pos = torch.arange(tq, device=q.device)
    for j in range(0, tk, block_size):
        k_j = k[:, j:j + block_size].float()
        v_j = v[:, j:j + block_size].float()
        mask = None
        if causal:
            k_pos = j + torch.arange(block_size, device=q.device)
            mask = (q_pos[:, None] + (tk - tq) >= k_pos[None, :])[None]
        if segment_ids is not None:
            q_seg, kv_seg = segment_ids
            seg = q_seg[:, :, None] == kv_seg[:, None, j:j + block_size]
            mask = seg if mask is None else mask & seg
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_j) * scale
        if mask is not None:
            s = torch.where(mask[:, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if mask is not None:
            p = torch.where(mask[:, None], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = (acc * corr.transpose(1, 2)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, v_j))
        m = m_new
    # l == 0 only for rows masked out of every block; emit zeros there.
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def _divisor_block(t: int, cap: int) -> int:
    """Largest divisor of ``t`` that is <= cap."""
    return next(b for b in range(min(cap, t), 0, -1) if t % b == 0)


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (sequence parallelism over a mesh) is not ported to "
            "tpunet_torch yet; it comes with ROADMAP Queue A item 8")
    fn.__name__ = name
    return fn


ring_attention = _not_ported("ring_attention")
ring_self_attention = _not_ported("ring_self_attention")
ulysses_attention = _not_ported("ulysses_attention")
ulysses_self_attention = _not_ported("ulysses_self_attention")
