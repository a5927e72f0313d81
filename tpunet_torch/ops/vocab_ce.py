"""Vocab-parallel (Megatron-style) cross-entropy for the LM, port of
``tpunet/ops/vocab_ce.py``.

The LM's head is tied to its embedding [V, C], and at a real vocabulary
the [B, T, V] float32 logits are the largest tensor of the train step.
Here each rank of the mesh's 'model' axis computes logits against only
its vocab slice of the (replicated) embedding, [B, T, V/vp], and the
softmax statistics are assembled with three small collectives over the
group, the max-subtracted log-sum-exp factorization tpunet uses:

    ce = lse - tgt_logit,
    lse = m + log(sum_ranks sum exp(logits_v - m)),  m = max_ranks max logits_v

The row max ``m`` carries no gradient (it cancels analytically from
``lse``); the exp-sum and the target logit are summed over the group
with the identity backward (every rank holds the same loss), the hidden
states enter through ``copy_to_group`` (their gradient summed over the
group), and the embedding's slice through :class:`_VocabSlice`, whose
backward all-gathers the slices' gradients into the whole table's.
``hit`` is ``tgt_logit >= m``: ``argmax == target`` except under a tie
for the max, as in tpunet. With ``smoothing`` s the CE is tpunet's
``lse - ((1 - s) * tgt_logit + s * mean_logit)``.

These are collectives and products, not a Pallas kernel in tpunet
either, so they stay plain torch. :func:`full_ce` is the full-logits
cross-entropy beside it, the tests' yardstick.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tpunet_torch.parallel import dist


def resolve_vocab_ce(vocab_ce: str, model_axis: int, vocab_size: int) -> str:
    """tpunet's resolution of ``--vocab-ce``: ``auto`` is ``sharded``
    whenever the 'model' axis is > 1 and divides the vocab, else
    ``full``; an explicit ``sharded`` raises where ``auto`` would fall
    back."""
    if vocab_ce not in ("auto", "sharded", "full"):
        raise ValueError(f"unknown vocab_ce {vocab_ce!r}; "
                         "expected auto|sharded|full")
    ok = model_axis > 1 and vocab_size % model_axis == 0
    if vocab_ce == "sharded" and not ok:
        raise ValueError(
            f"vocab_ce='sharded' needs a mesh 'model' axis > 1 that "
            f"divides the vocab ({vocab_size}); have model={model_axis}")
    if vocab_ce == "full":
        return "full"
    return "sharded" if ok else "full"


class _VocabSlice(torch.autograd.Function):
    """Rows [r*l, (r+1)*l) of the replicated table forward; backward,
    the slices' gradients of every rank gathered into the whole
    table's."""

    @staticmethod
    def forward(ctx, emb, group, rank, n):
        ctx.group = group
        rows = emb.shape[0] // n
        return emb[rank * rows:(rank + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        full = dist.all_gather(g, ctx.group)
        return full.reshape(-1, *g.shape[1:]), None, None, None


def vocab_parallel_ce(h: torch.Tensor, emb: torch.Tensor,
                      targets: torch.Tensor, group, *,
                      smoothing: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token CE and hit [B, T] float32 from hidden states ``h``
    [B, T, C] (cast to float32), the tied table ``emb`` [V, C] (the same
    on every rank of ``group``) and int ``targets`` [B, T]: those of
    ``h @ emb.T`` with logits only [B, T, V/vp] a rank. On a group of
    one, the same factorization over the whole vocab."""
    n, r = dist.group_size(group), (0 if dist.group_size(group) == 1
                                    else torch.distributed.get_rank(group))
    v = emb.shape[0]
    if v % n:
        raise ValueError(f"vocab {v} not divisible by the mesh 'model' "
                         f"axis ({n})")
    emb_l = emb if n == 1 else _VocabSlice.apply(emb, group, r, n)
    h = dist.copy_to_group(h.float(), group)
    logits = torch.matmul(h, emb_l.float().t())               # [B, T, v/n]
    m = dist.all_reduce_max(logits.detach().amax(-1), group)
    z = dist.reduce_from_group(
        torch.exp(logits - m[..., None]).sum(-1), group)
    lse = m + torch.log(z)
    rows = logits.shape[-1]
    off = r * rows
    tgt = targets.long()
    mine = (tgt >= off) & (tgt < off + rows)
    loc = (tgt - off).clamp(0, rows - 1)
    tl = torch.gather(logits, -1, loc[..., None])[..., 0]
    tgt_logit = dist.reduce_from_group(tl * mine.float(), group)
    if smoothing > 0.0:
        mean_logit = dist.reduce_from_group(logits.sum(-1), group) / v
        ce = lse - ((1.0 - smoothing) * tgt_logit + smoothing * mean_logit)
    else:
        ce = lse - tgt_logit
    hit = (tgt_logit.detach() >= m).float()
    return ce, hit


def full_ce(h: torch.Tensor, emb: torch.Tensor, targets: torch.Tensor, *,
            smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-logits CE and hit of the same inputs (the LM's default
    head and loss): [B, T, V] float32 logits materialised."""
    logits = torch.matmul(h.float(), emb.float().t())
    tgt = targets.long()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt.reshape(-1), reduction="none",
                         label_smoothing=smoothing).view_as(tgt)
    return ce, (logits.argmax(-1) == tgt).float()
