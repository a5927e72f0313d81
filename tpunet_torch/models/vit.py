"""Vision Transformer in PyTorch, port of ``tpunet/models/vit.py``.

Pre-LN encoder over non-overlapping patches, mean-pooled tokens (no CLS
token), a linear head; float32 parameters, activations in ``dtype``
(bf16 on the card), logits in float32. The parameter names mirror the
Flax tree (``patch_embed``, ``pos_embed``, ``blocks.<i>.{ln1, attn.qkv,
attn.out, ln2, mlp.fc1, mlp.fc2}``, ``ln``, ``classifier``), with torch
layouts: Dense kernels as ``weight`` [out, in], the patch kernel OIHW;
``tpunet_torch.models.convert.vit_state_dict_from_jax`` carries a Flax
tree across.

Flax's defaults, kept: LayerNorm epsilon 1e-6; GELU in its tanh form;
the mean pool after the final LayerNorm; the classifier initialised to
zero. The patch embedding (a p x p stride-p convolution) is written as
the patches unfolded and one matrix product, so that a float32 forward
on the card is float32 (cuDNN would run the convolution in TF32) and the
product goes to a single large GEMM.

``forward(x, train=False, generator=None)`` takes normalised images
[N,3,H,W] (any memory format), as MobileNetV2's does, so the train
step, the Predictor and the Trainer need no branch. The attention core
is injected (:func:`make_attn_fn`): ``auto`` and ``flash`` give
``tpunet_torch.ops.flash.flash_attention`` (the hand-written kernels on
the card, their plain versions on the CPU), ``dense`` and ``blockwise``
the plain versions of ``tpunet_torch.ops.attention``; q, k and v reach
it as views of the fused projection. Dropout (``dropout_rate``) sits
after the position embedding, each attention output and each MLP, 25
masks in ViT-B/16: their bits come from a generator on the activations'
device, seeded by one draw from the step's generator and this process's
index on the mesh's 'data' axis, so no mask is drawn on the host and
copied. Under data parallelism each rank therefore draws its own masks:
with dropout above 0, N ranks do not repeat the masks of one rank on the
same global batch (they already differ between the CPU and the card); at
dropout 0 they compute the same step. In eval mode the weights cast to
``dtype`` are computed once and reused until a parameter changes.

Tensor parallelism (:meth:`Encoder.set_tensor_parallel`, the mesh's
'model' axis): each rank holds its heads of the qkv projection and its
columns of fc1 (column-parallel), and the matching input columns of
``attn.out`` and fc2 (row-parallel); ``tpunet_torch.parallel.tp`` says
which, ``tpunet_torch.models.convert.shard_state_dict`` cuts them. The
block's input enters the column-parallel layers through
``copy_to_group`` (its gradient all-reduced over the group in the
backward), and a row-parallel product is all-reduced
(``reduce_from_group``) before its bias: two all-reduces a block
forward, two backward, Megatron's. The attention core runs on the
rank's heads. Every dropout mask lies on a replicated activation (the
embedding sum, the attention and MLP outputs after their reduce), and
the ranks of one 'model' group share the data index the masks are
seeded from, so their masks are equal and tensor parallelism computes
one rank's step at any dropout rate. The replicated leaves' gradients
are averaged over the group before the update
(``tpunet_torch.train.state.Sharding``): the ranks compute them alike
but for the order of CUDA's atomic accumulations.

The blocks' arithmetic lives in :class:`Encoder`, which the LM
(``tpunet_torch.models.lm``) shares, with tpunet's decode paths, which
skip the attention core: the module-clock step of ``generate``
(:func:`decode_attend` at one shared index) and the serving engine's
(:class:`ServeStep`): per-row positions with T >= 1 queries a row (a
chunked causal prefill) and an ``active`` gate, against a dense
:class:`KVCache` (:func:`decode_attend`) or a shared page pool
(:class:`PagedKV`, :func:`paged_decode_attend`), whose pages hold the
compute dtype, bf16, or int8 codes with a float32 scale a token row
(:func:`quantize_kv_rows`, dequantised on the gather). Every cache is
per-layer tensors written in place. With ``remat`` (``--remat``) a
training forward runs each block under ``torch.utils.checkpoint``, so
the backward recomputes it (the flash forward launches twice a layer a
step), with the block's dropout masks drawn again from the same
generator state; decode steps are never wrapped.

Sequence parallelism (``attention`` ``ring`` or ``ulysses``, the mesh's
'seq' axis of S ranks, :meth:`Encoder.seq_shard`): every rank of a
'seq' group gets the whole input, and a forward without a cache keeps
rank r's tokens ``r*T/S`` to ``(r+1)*T/S`` from the embedding plus
positions on, through every block; the core is
``tpunet_torch.ops.attention.ring_self_attention`` or
``ulysses_self_attention``. Each dropout mask is drawn at the whole
sequence's shape from the generator that the group's ranks share and
sliced, so the group draws one rank's masks (remat's fork too). The
ViT's mean pool sums the rank's tokens and then sums over the group
(``all_reduce_sum``, differentiable) before it divides by T, so every
rank holds the whole logits.

MoE (``moe_experts`` > 0, :func:`make_blocks`): every ``moe_every``-th
block's MLP is the sparse MLP of ``tpunet_torch.models.moe`` (the
router ``blocks.<i>.moe.router``, the experts ``moe.wi``/``bi``/``wo``/
``bo``), after the same dropout. A training forward collects the blocks'
load-balance terms, which :meth:`Encoder.moe_aux_loss` hands to the
step (under remat each is an output of the checkpointed block). Under
tensor parallelism an MoE block is not Megatron-split: its experts are
this rank's share of the 'model' axis (expert parallelism) and its
router is whole.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tpunet_torch.config import SEQ_ATTENTIONS
from tpunet_torch.models.moe import MoeMlp, moe_apply, resolve_moe_dispatch
from tpunet_torch.ops.attention import (_NEG_INF, blockwise_attention,
                                        dense_attention, ring_self_attention,
                                        ulysses_self_attention)
from tpunet_torch.ops.flash import flash_attention
from tpunet_torch.parallel.dist import (SELF, all_reduce_max,
                                        all_reduce_sum, copy_to_group,
                                        group_size, reduce_from_group)
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size

AttnFn = Callable[..., torch.Tensor]  # (q, k, v) BTHD -> BTHD

LN_EPSILON = 1e-6      # flax.linen.LayerNorm's default

# Name -> (patch, hidden, depth, heads). "vit" uses the ModelConfig's
# vit_* fields directly.
VIT_PRESETS = {
    "vit_tiny": (16, 192, 12, 3),
    "vit_small": (16, 384, 12, 6),
    "vit_base": (16, 768, 12, 12),
}


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))


class LayerNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class Attention(nn.Module):
    """The fused qkv projection [C -> 3C] and the output projection."""

    def __init__(self, c: int):
        super().__init__()
        self.qkv = Dense(c, 3 * c)
        self.out = Dense(c, c)


class MlpBlock(nn.Module):
    def __init__(self, c: int, mlp_dim: int):
        super().__init__()
        self.fc1 = Dense(c, mlp_dim)
        self.fc2 = Dense(mlp_dim, c)


class EncoderBlock(nn.Module):
    """Pre-LN block: x + Attn(LN(x)); x + Mlp(LN(x)). With ``moe`` (a
    dict of :class:`tpunet_torch.models.moe.MoeMlp`'s keyword arguments)
    the MLP is the sparse ``moe`` in place of ``mlp``."""

    def __init__(self, c: int, mlp_dim: int, moe: Optional[dict] = None):
        super().__init__()
        self.ln1 = LayerNorm(c)
        self.attn = Attention(c)
        self.ln2 = LayerNorm(c)
        if moe:
            self.moe = MoeMlp(c, mlp_dim, **moe)
        else:
            self.mlp = MlpBlock(c, mlp_dim)


def make_blocks(hidden: int, mlp_dim: int, depth: int, moe_experts: int = 0,
                moe_every: int = 2, moe_top_k: int = 2,
                moe_capacity_factor: float = 1.25,
                moe_dispatch: str = "auto") -> nn.ModuleList:
    """``depth`` blocks, ViT-MoE's placement (tpunet's): with experts, the
    sparse MLP in block i when ``i % moe_every == moe_every - 1`` (the
    later block of each pair at the default 2), dense elsewhere."""
    if moe_experts > 0 and moe_every < 1:
        raise ValueError(f"moe_every must be >= 1, got {moe_every}")
    moe = dict(num_experts=moe_experts, top_k=moe_top_k,
               capacity_factor=moe_capacity_factor, dispatch=moe_dispatch)
    return nn.ModuleList(
        EncoderBlock(hidden, mlp_dim, moe if moe_experts > 0
                     and i % moe_every == moe_every - 1 else None)
        for i in range(depth))


def moe_kwargs(cfg) -> dict:
    """:func:`make_blocks`' MoE arguments of a ModelConfig."""
    return dict(moe_experts=cfg.moe_experts, moe_every=cfg.moe_every,
                moe_top_k=cfg.moe_top_k,
                moe_capacity_factor=cfg.moe_capacity_factor,
                moe_dispatch=cfg.moe_dispatch)


class PatchEmbed(nn.Module):
    """The p x p stride-p patch convolution's weight [hidden, 3, p, p]."""

    def __init__(self, hidden: int, patch: int, channels: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden, channels, patch, patch))
        self.bias = nn.Parameter(torch.zeros(hidden))


@dataclasses.dataclass(frozen=True)
class KVCache:
    """The decode cache of a decoder stack: per layer the cached keys and
    values in the activation dtype (or the page dtype), and ``index``,
    the position the next token is written at on the module clock
    (tpunet's ``cached_k``/``cached_v``/``cache_index``). Dense, each is
    [B, total, H, D]; paged, each is a flat pool [pages * page_tokens,
    H, D], and int8 pages add ``sk``/``sv``, per layer the float32 scale
    of each flat row [pages * page_tokens] (tpunet's ``scale_k``/
    ``scale_v``). A decode step writes its K/V into the tensors in place;
    a module-clock step returns the cache advanced by one, and the cache
    it was given shares those tensors and is stale afterwards."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    index: int = 0
    sk: Tuple[torch.Tensor, ...] = ()
    sv: Tuple[torch.Tensor, ...] = ()

    @classmethod
    def zeros(cls, depth: int, batch: int, total: int, heads: int,
              head_dim: int, dtype: torch.dtype, device) -> "KVCache":
        def make():
            return tuple(torch.zeros(batch, total, heads, head_dim,
                                     dtype=dtype, device=device)
                         for _ in range(depth))
        return cls(make(), make(), 0)

    @classmethod
    def paged(cls, depth: int, paged_kv: "PagedKV", heads: int,
              head_dim: int, dtype: torch.dtype, device) -> "KVCache":
        """An empty page pool of ``paged_kv``'s geometry, pages stored in
        ``paged_kv.store_dtype(dtype)``."""
        rows = paged_kv.pages * paged_kv.page_tokens
        store = paged_kv.store_dtype(dtype)

        def make(*shape, dtype=store):
            return tuple(torch.zeros(rows, *shape, dtype=dtype,
                                     device=device) for _ in range(depth))
        scales = ((make(dtype=torch.float32), make(dtype=torch.float32))
                  if paged_kv.quantized else ((), ()))
        return cls(make(heads, head_dim), make(heads, head_dim), 0, *scales)

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor of the cache in a fixed order: the keys, the
        values, then the scales of int8 pages, each by layer. A paged
        cache's leaves are all indexed by flat row on dim 0."""
        return self.k + self.v + self.sk + self.sv

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves())


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """Paged KV geometry, tpunet's ``PagedKV`` (``tpunet/models/vit.py``):
    K/V live in a shared pool of ``pages`` pages of ``page_tokens``
    tokens each (page 0 included, the reserved garbage page: inactive
    rows and the padded tail of a bucketed prefill write there, and the
    engine never hands it out), addressed through a per-row page table.
    ``dtype`` is the page payload: ``auto`` stores at the compute dtype,
    ``bfloat16``/``bf16`` halves float32 payloads, ``int8`` quantizes each
    written token row against its own absmax with the float32 scale
    stored beside the page (a scale a page row: one a page could not
    absorb incremental writes without rescaling the page) and
    dequantizes on the gather."""

    pages: int            # total pages INCLUDING the reserved page 0
    page_tokens: int      # tokens per page
    dtype: str = "auto"   # auto | bfloat16 | bf16 | int8

    def __post_init__(self):
        if self.dtype not in ("auto", "bfloat16", "bf16", "int8"):
            raise ValueError(f"unknown kv dtype {self.dtype!r}")

    def store_dtype(self, compute_dtype: torch.dtype) -> torch.dtype:
        if self.dtype == "auto":
            return compute_dtype
        return torch.int8 if self.quantized else torch.bfloat16

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"


def quantize_kv_rows(x: torch.Tensor, group=SELF
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``x`` [N, H, D] a token row, tpunet's
    ``_quantize_kv_rows`` (``tpunet/models/vit.py:87-96``): each row over
    its own absmax across (H, D) in float32, so one outlier token cannot
    crush every other row's resolution. The scale is ``amax / 127`` (1
    for an all-zero row); the codes are ``x / scale`` rounded half to
    even and clamped to +-127. Both divisions are true divisions on both
    devices: CUDA divides by a CPU scalar as a multiply by its reciprocal,
    which rounds differently, so 127 is a tensor on ``x``'s device.
    Under tensor parallelism ``x`` holds this rank's heads and ``group``
    is the 'model' group: the absmax is taken over every rank's heads
    (an all-reduce max, as GSPMD reduces tpunet's over the shards), so
    the scales are one card's and the codes its heads' codes.
    Returns (int8 codes [N, H, D], float32 scales [N])."""
    xf = x.float()
    amax = all_reduce_max(xf.abs().amax(dim=(1, 2)), group)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.round(xf / scale[:, None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class ServeStep:
    """The serving engine's decode call (tpunet's ``positions``/``active``
    /``paged_kv``/``page_table`` hooks): row b's T queries sit at
    ``positions[b] + i`` and write their K/V there; ``active`` [B] bool
    gates the writes (an inactive row's cache stays bit-frozen);
    ``page_table`` [B, pages a row] int32 maps positions to pool pages
    when ``paged_kv`` is set. The engine owns the clock: the cache's
    ``index`` is neither read nor advanced. Every row attends the whole
    cache (its keys past the row's queries masked), as tpunet does: the
    attend's shapes never depend on the batch partners, so neither do a
    row's results."""

    positions: torch.Tensor
    active: Optional[torch.Tensor] = None
    paged_kv: Optional[PagedKV] = None
    page_table: Optional[torch.Tensor] = None


def _masked_attend(q: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                   qpos: torch.Tensor) -> torch.Tensor:
    """q [B,T,H,D] against keys kf, vf [B,K,H,D] (q's dtype), query i of
    row b at ``qpos[b, i]`` seeing keys ``j <= qpos``: scores in float32
    times D^-1/2, masked to -1e30, softmax in float32, p kept in float32
    against V, the result cast to q's dtype (tpunet's inline attend)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float())
    s = s * q.shape[-1] ** -0.5
    keys = torch.arange(kf.shape[1], device=q.device)
    valid = keys[None, None, :] <= qpos[:, :, None]                # [B,T,K]
    s = s.masked_fill(~valid[:, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf.float()).to(q.dtype)


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cached_k: torch.Tensor, cached_v: torch.Tensor,
                  positions, active: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Attention of new tokens against a dense cache [B, total, H, D],
    tpunet's ``_decode_attend`` (``tpunet/models/vit.py:159-214``).

    ``positions`` an int: the module clock of ``generate``; one token
    [B, 1, H, D] is written at that index (in place), then q attends to
    positions 0..index (the masked positions past it, probability exactly
    0 in tpunet, are left out of the sums).

    ``positions`` a [B] tensor: the serving engine's rows; row b's T
    tokens are written at ``positions[b] .. positions[b] + T - 1``, the
    start clamped to ``total - T`` as XLA clamps a ``dynamic_update_slice``
    (the engine never reaches the clamp), only where ``active`` (inactive
    rows write their own cached rows back, so they stay bit-frozen); then
    query i attends to keys ``j <= positions[b] + i``."""
    b, t, h, d = k.shape
    total = cached_k.shape[1]
    if not torch.is_tensor(positions):
        index = int(positions)
        if t != 1:
            raise ValueError(f"decode processes one token per call, got {t}")
        if index >= total:
            raise ValueError(f"decode position {index} is past the cache's "
                             f"{total} positions")
        cached_k[:, index] = k[:, 0]
        cached_v[:, index] = v[:, 0]
        kf = cached_k[:, :index + 1].float()
        vf = cached_v[:, :index + 1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if t > total:
        raise ValueError(f"{t} tokens a row exceed the cache's {total} "
                         "positions")
    arange_t = torch.arange(t, device=k.device)
    start = positions.to(torch.long).clamp(0, total - t)
    flat = (torch.arange(b, device=k.device)[:, None] * total
            + start[:, None] + arange_t[None, :]).reshape(-1)       # [B*T]
    ck = cached_k.view(b * total, h, d)
    cv = cached_v.view(b * total, h, d)
    k_rows = k.reshape(b * t, h, d)
    v_rows = v.reshape(b * t, h, d)
    if active is not None:
        keep = active.repeat_interleave(t)[:, None, None]
        k_rows = torch.where(keep, k_rows, ck.index_select(0, flat))
        v_rows = torch.where(keep, v_rows, cv.index_select(0, flat))
    ck.index_copy_(0, flat, k_rows.to(ck.dtype))
    cv.index_copy_(0, flat, v_rows.to(cv.dtype))
    qpos = positions.to(torch.long)[:, None] + arange_t[None, :]     # [B,T]
    return _masked_attend(q, cached_k, cached_v, qpos)


def paged_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cached_k: torch.Tensor, cached_v: torch.Tensor,
                        positions: torch.Tensor, page_table: torch.Tensor,
                        page_tokens: int,
                        active: Optional[torch.Tensor] = None,
                        scale_k: Optional[torch.Tensor] = None,
                        scale_v: Optional[torch.Tensor] = None,
                        group=SELF) -> torch.Tensor:
    """Attention of new tokens against a shared page pool, tpunet's
    ``_paged_decode_attend`` (``tpunet/models/vit.py:216-320``).

    The pool per layer is flat, [pages * page_tokens, H, D]; row b's
    position p lives at flat row ``page_table[b, p // page_tokens] *
    page_tokens + p % page_tokens``. The T new K/V rows a row are written
    in one ``index_copy_`` (page slot clipped to the table, as tpunet
    clips it; inactive rows redirected into the garbage page 0, whose
    duplicate writes land in any order, as nothing reads page 0
    unmasked). Then each row's pages are gathered back into position order
    and attended with the dense masked math, query i of row b seeing keys
    ``j <= positions[b] + i``. The writes touch only positions >=
    ``positions[b]``, so pages below it (the prefix cache's shared pages)
    are never written.

    int8 pages (``scale_k``/``scale_v`` given, each [pages * page_tokens]
    float32): the new rows are quantized (:func:`quantize_kv_rows`) and
    their scales written by the same indices; the gather dequantizes,
    codes times scale in float32, then casts to q's dtype, as tpunet
    does; under tensor parallelism ``group`` is the 'model' group the
    quantizer takes its row absmax over."""
    b, t, h, d = k.shape
    pt = int(page_tokens)
    slots = page_table.shape[1]
    table = page_table.to(torch.long)
    pos_t = (positions.to(torch.long)[:, None]
             + torch.arange(t, device=k.device)[None, :])             # [B,T]
    page_slot = (pos_t // pt).clamp(0, slots - 1)
    flat = torch.gather(table, 1, page_slot) * pt + pos_t % pt
    if active is not None:
        flat = torch.where(active[:, None], flat, torch.zeros_like(flat))
    flat = flat.reshape(-1)
    k_rows, v_rows = k.reshape(b * t, h, d), v.reshape(b * t, h, d)
    rows = (table[:, :, None] * pt
            + torch.arange(pt, device=k.device)[None, None, :]).reshape(-1)
    if scale_k is None:
        cached_k.index_copy_(0, flat, k_rows.to(cached_k.dtype))
        cached_v.index_copy_(0, flat, v_rows.to(cached_v.dtype))
        kf = cached_k.index_select(0, rows)
        vf = cached_v.index_select(0, rows)
    else:
        for pool, scales, x in ((cached_k, scale_k, k_rows),
                                (cached_v, scale_v, v_rows)):
            codes, s = quantize_kv_rows(x, group)
            pool.index_copy_(0, flat, codes)
            scales.index_copy_(0, flat, s)
        kf = (cached_k.index_select(0, rows).float()
              * scale_k.index_select(0, rows)[:, None, None])
        vf = (cached_v.index_select(0, rows).float()
              * scale_v.index_select(0, rows)[:, None, None])
    kf = kf.view(b, slots * pt, h, d).to(q.dtype)
    vf = vf.view(b, slots * pt, h, d).to(q.dtype)
    return _masked_attend(q, kf, vf, pos_t)


def _layer_attend(cache: KVCache, i: int, step: Optional[ServeStep],
                  group=SELF) -> AttnFn:
    """Layer ``i``'s decode attend against ``cache`` (``group``: the
    tensor-parallel group of int8 pages' quantizer)."""
    ck, cv = cache.k[i], cache.v[i]
    if step is None:
        return functools.partial(decode_attend, cached_k=ck, cached_v=cv,
                                 positions=cache.index)
    if step.paged_kv is not None:
        scales = {}
        if step.paged_kv.quantized:
            scales = dict(scale_k=cache.sk[i], scale_v=cache.sv[i],
                          group=group)
        return functools.partial(
            paged_decode_attend, cached_k=ck, cached_v=cv,
            positions=step.positions, page_table=step.page_table,
            page_tokens=step.paged_kv.page_tokens, active=step.active,
            **scales)
    return functools.partial(decode_attend, cached_k=ck, cached_v=cv,
                             positions=step.positions, active=step.active)


class Dropout:
    """One forward's dropout: each call draws a Bernoulli(1 - rate) mask
    from ``bits`` (a generator on the activations' device) and returns
    ``x * mask / (1 - rate)``; the identity without a generator. The
    generator's state can be read, forked and set, which remat needs.
    ``shard`` (n, r): ``x`` is shard r of n along the tokens (dim 1),
    and the mask is drawn at the whole sequence's shape and sliced, so
    the n ranks of a 'seq' group draw one rank's masks between them."""

    def __init__(self, bits: Optional[torch.Generator], rate: float,
                 shard: Tuple[int, int] = (1, 0)):
        self.bits, self.keep, self.shard = bits, 1.0 - rate, shard

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return x
        n, r = self.shard
        t = x.shape[1]
        mask = x.new_empty((x.shape[0], t * n) + x.shape[2:]).bernoulli_(
            self.keep, generator=self.bits)
        if n > 1:
            mask = mask.narrow(1, r * t, t)
        return x * mask / self.keep

    def state(self) -> Optional[torch.Tensor]:
        return None if self.bits is None else self.bits.get_state()

    def set_state(self, state: Optional[torch.Tensor]) -> None:
        if self.bits is not None:
            self.bits.set_state(state)

    def fork(self, state: Optional[torch.Tensor]) -> "Dropout":
        """A dropout of the same rate on a new generator at ``state``."""
        if self.bits is None:
            return self
        bits = torch.Generator(device=self.bits.device)
        bits.set_state(state)
        return Dropout(bits, 1.0 - self.keep, self.shard)


class Encoder(nn.Module):
    """The machinery the ViT and the LM share: the pre-LN blocks'
    arithmetic in the activation dtype over float32 parameters, the
    step's dropout, and the injected attention core. A subclass
    registers ``blocks`` (a ModuleList of :class:`EncoderBlock`)."""

    def __init__(self, heads: int, dropout_rate: float, attn_fn: AttnFn,
                 dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.attn_fn = attn_fn
        self.dtype = dtype
        # ModelConfig.remat: checkpoint each block of a training forward.
        self.remat = False
        # Tensor parallelism over the 'model' axis group (None is the
        # whole world); expert parallelism alone (the pipelined models:
        # the MoE blocks' experts over the group, the rest whole).
        self.tensor_parallel = False
        self.expert_parallel = False
        self.tp_group = None
        # The mesh axes the MoE load-balance statistics are summed over
        # (the pipelined models' stages route each microbatch-shard on
        # its own: none).
        self.aux_axes = ("data", "seq")
        # A sequence-parallel core (ring/Ulysses): a training or eval
        # forward computes this rank's share of the tokens on the mesh's
        # 'seq' axis (seq_shard).
        self.seq_parallel = False
        # id(parameter) -> (source state, parameter, cast copy); eval only.
        self._consts: Dict[int, tuple] = {}
        # The MoE load-balance terms of the last training forward.
        self._aux: list = []

    def moe_aux_loss(self) -> Optional[torch.Tensor]:
        """The sum of the MoE blocks' load-balance terms of the last
        training forward (tpunet's sown 'losses'), None without MoE
        blocks; read once: the terms are dropped."""
        aux, self._aux = self._aux, []
        return sum(aux) if aux else None

    def _cast(self, t: torch.Tensor, train: bool) -> torch.Tensor:
        """``t`` in the activation dtype. In eval mode the cast is made
        once and reused until ``t`` changes (load_state_dict and in-place
        updates bump its version, ``.to()`` moves its storage); in train
        mode it is made under autograd on every call."""
        if train or t.is_inference():
            return t.to(self.dtype)
        state = (t.data_ptr(), t._version, self.dtype)
        hit = self._consts.get(id(t))
        if hit is None or hit[0] != state:
            with torch.inference_mode(False), torch.no_grad():
                hit = (state, t, t.to(self.dtype))
            self._consts[id(t)] = hit
        return hit[2]

    def set_tensor_parallel(self, group) -> None:
        """Compute as one rank of the tensor-parallel ``group``: the
        blocks' TP leaves must hold this rank's pieces."""
        self.tensor_parallel, self.tp_group = True, group

    @property
    def tp_group_or_self(self):
        """The tensor-parallel group, ``dist.SELF`` without tensor
        parallelism (a group of None is the whole world)."""
        return self.tp_group if self.tensor_parallel else SELF

    @property
    def local_heads(self) -> int:
        """The heads this rank computes: its share of the 'model' group
        under tensor parallelism, all of them otherwise."""
        return self.heads // group_size(self.tp_group_or_self)

    def set_expert_parallel(self, group) -> None:
        """Compute the MoE blocks as one rank of the expert-parallel
        ``group`` (their experts must be this rank's); everything else
        whole."""
        self.expert_parallel, self.tp_group = True, group

    def seq_shard(self) -> Tuple[int, int]:
        """(n, r): this rank computes token shard r of n of a forward
        without a cache, the current mesh's 'seq' axis when the core is
        sequence-parallel; (1, 0) otherwise."""
        if not self.seq_parallel:
            return 1, 0
        return axis_size("seq"), axis_index("seq")

    def _seq_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``x`` along dim 1 (the tokens)."""
        n, r = self.seq_shard()
        if n == 1:
            return x
        t = x.shape[1]
        if t % n:
            raise ValueError(f"sequence of {t} tokens not divisible by "
                             f"sequence axis {n}")
        return x[:, r * t // n:(r + 1) * t // n]

    def _linear(self, dense: Dense, x: torch.Tensor, train: bool):
        return F.linear(x, self._cast(dense.weight, train),
                        self._cast(dense.bias, train))

    def _column_in(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated activation entering column-parallel layers."""
        if not self.tensor_parallel:
            return x
        return copy_to_group(x, self.tp_group)

    def _row_linear(self, dense: Dense, x: torch.Tensor, train: bool):
        """A row-parallel layer: the partial product summed over the
        group, then the (replicated) bias."""
        if not self.tensor_parallel:
            return self._linear(dense, x, train)
        y = reduce_from_group(F.linear(x, self._cast(dense.weight, train)),
                              self.tp_group)
        return y + self._cast(dense.bias, train)

    def _norm(self, ln: LayerNorm, x: torch.Tensor, train: bool):
        return F.layer_norm(x, x.shape[-1:], self._cast(ln.weight, train),
                            self._cast(ln.bias, train), LN_EPSILON)

    def _dropout(self, train: bool, generator: Optional[torch.Generator],
                 device: torch.device) -> "Dropout":
        """The step's dropout: x -> x / keep where a Bernoulli(keep) draw
        is 1, else 0 (flax's ``nn.Dropout``); the identity in eval mode or
        at rate 0."""
        rate = self.dropout_rate
        if not train or rate == 0.0:
            return Dropout(None, 0.0)
        if generator is None:
            raise ValueError("train mode with dropout needs a generator")
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        # Rank 0 keeps the draw; the others step away from it by a large
        # odd constant (2^64 / golden ratio).
        seed = (seed + axis_index("data") * 0x9E3779B97F4A7C15) % 2**63
        return Dropout(torch.Generator(device=device).manual_seed(seed), rate,
                       self.seq_shard())

    def _attention(self, attn: Attention, x: torch.Tensor, train: bool,
                   segment_ids: Optional[torch.Tensor] = None,
                   attend: Optional[AttnFn] = None):
        """Self-attention of ``x`` [B,T,C]: the core over q, k, v views
        of the fused projection, with ``segment_ids`` [B,T] as both the
        query and the key segments (tpunet's ``segment_ids=(seg, seg)``);
        or, with ``attend`` (q, k, v) -> y, a decode step against the
        layer's cache, which skips the core."""
        b, t, c = x.shape
        qkv = self._linear(attn.qkv, self._column_in(x), train)
        # -1: the heads this rank holds (all of them without TP).
        q, k, v = qkv.view(b, t, 3, -1, c // self.heads).unbind(2)
        if attend is not None:
            y = attend(q, k, v)
        elif segment_ids is not None:
            y = self.attn_fn(q, k, v, segment_ids=(segment_ids, segment_ids))
        else:
            y = self.attn_fn(q, k, v)
        return self._row_linear(attn.out, y.reshape(b, t, -1), train)

    def _mlp(self, mlp: MlpBlock, x: torch.Tensor, train: bool):
        y = F.gelu(self._linear(mlp.fc1, self._column_in(x), train),
                   approximate="tanh")
        return self._row_linear(mlp.fc2, y, train)

    def _moe(self, moe: MoeMlp, x: torch.Tensor, train: bool,
             aux: Optional[list]) -> torch.Tensor:
        """The sparse MLP over the rank's tokens of ``x`` [B, T, C]; under
        tensor parallelism its experts are this rank's of the 'model'
        group (expert parallelism) and its router is whole. Routing and
        capacity are per call (a decode step routes its own tokens).
        Appends the load-balance term to ``aux`` when given."""
        b, t, c = x.shape
        ep = (group_size(self.tp_group) if self.tensor_parallel
              or self.expert_parallel else 1)
        y, term = moe_apply(
            x.reshape(b * t, c), moe.router.weight, moe.router.bias,
            *(self._cast(w, train) for w in (moe.wi, moe.bi, moe.wo,
                                             moe.bo)),
            num_experts=moe.num_experts, top_k=moe.top_k,
            capacity_factor=moe.capacity_factor, dtype=self.dtype,
            ep_group=self.tp_group, ep_impl=resolve_moe_dispatch(
                moe.dispatch, ep=ep, n_tokens=b * t,
                n_experts=moe.num_experts),
            aux=aux is not None, aux_axes=self.aux_axes)
        if term is not None:
            aux.append(term)
        return y.view(b, t, c)

    def _block(self, blk: "EncoderBlock", x: torch.Tensor, train: bool,
               drop: "Dropout", segment_ids: Optional[torch.Tensor],
               attend: Optional[AttnFn],
               aux: Optional[list] = None) -> torch.Tensor:
        """One block: x + drop(Attn(LN(x))); x + drop(Mlp(LN(x))), the
        MLP sparse in an MoE block (its load-balance term appended to
        ``aux`` when given)."""
        x = x + drop(self._attention(blk.attn, self._norm(blk.ln1, x, train),
                                     train, segment_ids, attend))
        h = self._norm(blk.ln2, x, train)
        moe = getattr(blk, "moe", None)
        y = (self._mlp(blk.mlp, h, train) if moe is None
             else self._moe(moe, h, train, aux))
        return x + drop(y)

    def _remat_block(self, blk: "EncoderBlock", x: torch.Tensor,
                     drop: "Dropout", segment_ids: Optional[torch.Tensor],
                     aux: list) -> torch.Tensor:
        """A training block under ``torch.utils.checkpoint``: only its
        input is kept, and the backward runs its forward again (the
        attention core included). The block's dropout masks come from a
        generator forked at the step generator's state before the block,
        so the recompute draws the masks the forward drew, and the step's
        generator then moves on as it would without remat. An MoE block's
        load-balance term is an output of the checkpointed function (the
        recompute's is dropped)."""
        start, end = drop.state(), {}

        def run(x):
            d, terms = drop.fork(start), []
            y = self._block(blk, x, True, d, segment_ids, None, terms)
            end["state"] = d.state()
            return (y, *terms)
        out = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
        drop.set_state(end["state"])
        aux.extend(out[1:])
        return out[0]

    def _encode(self, x: torch.Tensor, train: bool, drop: "Dropout",
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                step: Optional[ServeStep] = None) -> torch.Tensor:
        """The blocks over ``x``, against ``cache`` when one is given: on
        its module clock, or per row as ``step`` says. With ``remat`` a
        training forward recomputes each block in the backward; a decode
        step (a ``cache``) never does."""
        remat = (self.remat and train and cache is None
                 and torch.is_grad_enabled())
        # A training forward collects the MoE blocks' load-balance terms.
        aux = [] if train else None
        for i, blk in enumerate(self.blocks):
            if remat:
                x = self._remat_block(blk, x, drop, segment_ids, aux)
            else:
                attend = (None if cache is None
                          else _layer_attend(cache, i, step,
                                             self.tp_group_or_self))
                x = self._block(blk, x, train, drop, segment_ids, attend,
                                aux)
        self._aux = aux or []
        return x


class ViT(Encoder):
    """ViT backbone + linear head for ``image_size`` square images."""

    HEAD_KEYS = ("classifier.weight", "classifier.bias")

    def __init__(self, num_classes: int = 10, image_size: int = 224,
                 patch_size: int = 16, hidden: int = 192, depth: int = 6,
                 heads: int = 3, mlp_ratio: float = 4.0,
                 dropout_rate: float = 0.0,
                 attn_fn: AttnFn = dense_attention,
                 dtype: torch.dtype = torch.bfloat16, **moe):
        super().__init__(heads, dropout_rate, attn_fn, dtype)
        if image_size % patch_size:
            raise ValueError(f"image {image_size} not divisible by patch "
                             f"{patch_size}")
        if hidden % heads:
            raise ValueError(f"hidden dim {hidden} not divisible by {heads} "
                             "heads")
        self.num_classes = num_classes
        self.patch_size = patch_size
        tokens = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(hidden, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden))
        self.blocks = make_blocks(hidden, int(hidden * mlp_ratio), depth,
                                  **moe)
        self.ln = LayerNorm(hidden)
        self.classifier = Dense(hidden, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._embed(x, train)
        drop = self._dropout(train, generator, x.device)
        return self._head(self._encode(drop(x), train, drop), train)

    def _embed(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Images [N,C,H,W] -> the rank's patch tokens plus positions."""
        n, ch, h, w = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")
        # [N,C,H,W] -> [N, tokens, C*p*p], tokens row-major over the patch
        # grid and each patch in the (c, i, j) order of the OIHW weight;
        # through NHWC, so a channels_last input is copied once.
        x = x.to(self.dtype).permute(0, 2, 3, 1)
        x = x.reshape(n, h // p, p, w // p, p, ch).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(n, (h // p) * (w // p), ch * p * p)
        pe = self.patch_embed
        x = F.linear(x, self._cast(pe.weight, train).reshape(pe.weight.shape[0],
                                                             -1),
                     self._cast(pe.bias, train))
        return self._seq_slice(x + self._cast(self.pos_embed, train))

    def _head(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The blocks' output -> float32 logits: final LayerNorm, the mean
        pool over the tokens, the classifier."""
        x = self._norm(self.ln, x, train)
        if self.seq_shard()[0] == 1:
            x = x.mean(dim=1)  # mean pool over tokens
        else:
            # This rank's tokens summed, then the sum over the 'seq' group
            # (differentiable: each rank's share of the loss reaches its
            # own tokens).
            x = all_reduce_sum(x.sum(dim=1), axis_group("seq")) / (
                x.shape[1] * self.seq_shard()[0])
        return self._linear(self.classifier, x, train).float()


def make_attn_fn(cfg, causal: bool = False) -> AttnFn:
    """The configured attention core, ``causal`` for the LM: ``auto``
    and ``flash`` give the flash kernels (``attention_block`` is their
    TPU block size, not read by the CUDA kernels), ``dense`` the plain
    softmax, ``blockwise`` the chunked online softmax over
    ``attention_block`` keys; ``ring`` and ``ulysses`` the
    sequence-parallel attentions over the mesh's 'seq' axis with
    ``attention_core`` inside (``auto`` is the flash core)."""
    if cfg.attention in ("auto", "flash"):
        return functools.partial(flash_attention,
                                 block_q=cfg.attention_block,
                                 block_k=cfg.attention_block, causal=causal)
    if cfg.attention == "dense":
        return functools.partial(dense_attention, causal=causal)
    if cfg.attention == "blockwise":
        return functools.partial(blockwise_attention,
                                 block_size=cfg.attention_block,
                                 causal=causal)
    core = None if cfg.attention_core == "auto" else cfg.attention_core
    if cfg.attention == "ring":
        return functools.partial(ring_self_attention, causal=causal,
                                 core=core)
    if cfg.attention == "ulysses":
        return functools.partial(ulysses_self_attention, causal=causal,
                                 core=core, block=cfg.attention_block)
    raise ValueError(f"unknown attention {cfg.attention!r}")


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """Flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled so that the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def init_vit(model: ViT, generator: torch.Generator) -> None:
    """Flax's initialisers: lecun-normal Dense and patch kernels with zero
    biases, N(0, 0.02) position embedding, unit/zero LayerNorms and a
    zero classifier."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                _lecun_normal_(m.weight, m.weight.shape[1], generator)
                m.bias.zero_()
            elif isinstance(m, PatchEmbed):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                m.bias.zero_()
        init_moe(model, generator)
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
        model.classifier.weight.zero_()


def init_moe(model: nn.Module, generator: torch.Generator) -> None:
    """tpunet's MoE initialisers over every MoE block of ``model``."""
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.init_(generator)


def create_vit(cfg, image_size: int, generator: torch.Generator,
               cls=None) -> ViT:
    """The ViT of ``cfg``: a preset's (patch, hidden, depth, heads), or
    the ``vit_*`` fields for ``vit`` (and ``vit_pp``, whose class
    ``cls`` is)."""
    patch, hidden, depth, heads = VIT_PRESETS.get(cfg.name, (
        cfg.vit_patch, cfg.vit_hidden, cfg.vit_depth, cfg.vit_heads))
    model = (cls or ViT)(num_classes=cfg.num_classes, image_size=image_size,
                patch_size=patch, hidden=hidden, depth=depth, heads=heads,
                mlp_ratio=cfg.vit_mlp_ratio, dropout_rate=cfg.dropout_rate,
                attn_fn=make_attn_fn(cfg), dtype=getattr(torch, cfg.dtype),
                **moe_kwargs(cfg))
    model.remat = cfg.remat
    model.seq_parallel = cfg.attention in SEQ_ATTENTIONS
    init_vit(model, generator)
    return model
