"""Decoder-only transformer LM in PyTorch, port of ``tpunet/models/lm.py``.

Token embedding + learned positions -> the ViT's pre-LN blocks with a
causal attention core (:class:`tpunet_torch.models.vit.Encoder`) -> final
LayerNorm -> logits against the embedding's transpose (a tied head).
float32 parameters, activations in ``dtype`` (bf16 on the card), logits
in float32: the head is ``x.float() @ embed.weight.T``, a float32 product
as tpunet computes it outside any kernel. The parameter names mirror the
Flax tree (``embed``, ``pos_embed``, ``blocks.<i>``, ``ln``);
``tpunet_torch.models.convert.lm_state_dict_from_jax`` carries a Flax
tree across.

``forward(tokens, ...)`` takes int tokens [B, T] and returns logits
[B, T, vocab]:

- ``segment_ids`` [B, T] (packed documents) mask attention to
  same-segment pairs, composed with causality in the core (the flash
  kernels on the card, their plain versions on the CPU);
- ``cache`` (a :class:`KVCache` from :meth:`TransformerLM.init_cache`)
  runs one decode step of one token at ``pos_offset`` against the cache,
  skipping the core, and returns ``(logits, cache advanced by one)``;
- ``pos_offset`` a [B] tensor with a ``cache`` (the serving engine's
  call, tpunet's per-row hooks): row b's T tokens sit at ``pos_offset[b]
  + i`` (positions gathered from the table, clipped to it as tpunet
  clips the padded tail of a bucketed prefill), ``decode_active`` [B]
  gates each row's cache writes, and ``paged_kv`` with ``page_table``
  address a shared page pool (:meth:`TransformerLM.init_paged_cache`).
  Returns ``(logits, cache)``: the engine owns the clock.

:func:`filter_logits` and :func:`generate` are tpunet's sampling filter
and its generation loop: the KV-cache path (prompt and new tokens one
token a call) or ``use_cache=False``, the full-prefix recompute over a
fixed-size buffer (the flash forward, one launch a layer a token).
Sampling draws with ``torch.multinomial`` from an explicit generator,
one draw a new token: JAX's key stream cannot be matched, so a sampled
stream is deterministic per seed within the port, and a greedy stream
equals tpunet's. Not ported: the hidden states for the vocab-sharded
cross-entropy, MoE blocks and ``lm_pp`` (ROADMAP Queue A item 8), block
remat (item 2b).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpunet_torch.models.vit import (AttnFn, Dense, Encoder, EncoderBlock,
                                     KVCache, LayerNorm, PagedKV, ServeStep,
                                     _lecun_normal_, make_attn_fn)
from tpunet_torch.ops.attention import dense_attention


class Embed(nn.Module):
    """The token table [vocab, hidden], float32."""

    def __init__(self, vocab: int, hidden: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, hidden))


class TransformerLM(Encoder):
    """tokens [B, T] int -> logits [B, T, vocab] float32."""

    HEAD_KEYS = ()       # the head is the embedding: nothing to skip

    def __init__(self, vocab_size: int = 256, hidden: int = 192,
                 depth: int = 6, heads: int = 3, mlp_ratio: float = 4.0,
                 max_len: int = 1024, dropout_rate: float = 0.0,
                 attn_fn: Optional[AttnFn] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(heads, dropout_rate,
                         attn_fn if attn_fn is not None else dense_attention,
                         dtype)
        if hidden % heads:
            raise ValueError(f"hidden dim {hidden} not divisible by {heads} "
                             "heads")
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.mlp_ratio = mlp_ratio
        self.max_len = max_len
        self.embed = Embed(vocab_size, hidden)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, hidden))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, int(hidden * mlp_ratio)) for _ in range(depth))
        self.ln = LayerNorm(hidden)

    def clone(self, **overrides) -> "TransformerLM":
        """A model of this one's configuration with ``overrides`` (keyword
        arguments of the constructor, Flax's ``Module.clone``), on the
        CPU; its parameters are uninitialised: load them or
        :func:`init_lm` them, then move it."""
        kw = dict(vocab_size=self.vocab_size, hidden=self.hidden,
                  depth=len(self.blocks), heads=self.heads,
                  mlp_ratio=self.mlp_ratio, max_len=self.max_len,
                  dropout_rate=self.dropout_rate, attn_fn=self.attn_fn,
                  dtype=self.dtype)
        kw.update(overrides)
        return TransformerLM(**kw)

    def init_cache(self, batch: int, total: int) -> KVCache:
        """An empty decode cache for ``batch`` rows of ``total`` positions,
        on the parameters' device, in the activation dtype."""
        hidden = self.pos_embed.shape[-1]
        return KVCache.zeros(len(self.blocks), batch, total, self.heads,
                             hidden // self.heads, self.dtype,
                             self.pos_embed.device)

    def init_paged_cache(self, paged_kv: PagedKV) -> KVCache:
        """An empty shared page pool of ``paged_kv``'s geometry, per layer
        [pages * page_tokens, heads, head_dim] (and the float32 row scales
        of int8 pages), on the parameters' device."""
        hidden = self.pos_embed.shape[-1]
        return KVCache.paged(len(self.blocks), paged_kv, self.heads,
                             hidden // self.heads, self.dtype,
                             self.pos_embed.device)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                pos_offset=0,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                return_hidden: bool = False,
                decode_active: Optional[torch.Tensor] = None,
                paged_kv: Optional[PagedKV] = None,
                page_table: Optional[torch.Tensor] = None):
        """Logits [B, T, vocab] float32, or ``(logits, cache)`` with a
        ``cache``. ``pos_offset`` is the absolute position of
        ``tokens[:, 0]``: a scalar, or with a ``cache`` a [B] tensor
        (each row its own position; ``decode_active``, ``paged_kv`` and
        ``page_table`` go with it)."""
        if return_hidden:
            raise NotImplementedError(
                "return_hidden (the vocab-sharded cross-entropy's hook) is "
                "not ported to tpunet_torch yet; it comes with ROADMAP "
                "Queue A item 8")
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        if cache is not None and segment_ids is not None:
            raise ValueError("a decode step takes no segment_ids")
        per_row = torch.is_tensor(pos_offset) and pos_offset.dim() == 1
        step = None
        pos = self._cast(self.pos_embed, train)
        if per_row:
            if cache is None:
                raise ValueError("per-row pos_offset is a decode step: it "
                                 "needs a cache")
            if (paged_kv is None) != (page_table is None):
                raise ValueError("paged_kv and page_table go together")
            # Each row's slice of the position table; the clip covers the
            # padded tail of a bucketed prefill (whose K/V no query sees).
            idx = (pos_offset.to(torch.long)[:, None]
                   + torch.arange(t, device=tokens.device)[None, :])
            pos = pos[0][idx.clamp(0, self.max_len - 1)]
            step = ServeStep(pos_offset, decode_active, paged_kv,
                             page_table)
        else:
            if (decode_active is not None or paged_kv is not None
                    or page_table is not None):
                raise ValueError("decode_active, paged_kv and page_table "
                                 "need per-row pos_offset")
            pos_offset = int(pos_offset)
            if pos_offset < 0 or pos_offset + t > self.max_len:
                raise ValueError(f"positions {pos_offset}.."
                                 f"{pos_offset + t - 1} outside the table of "
                                 f"{self.max_len}")
            pos = pos[:, pos_offset:pos_offset + t]
        x = F.embedding(tokens.long(), self.embed.weight).to(self.dtype)
        x = x + pos
        drop = self._dropout(train, generator, x.device)
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32)
        x = self._encode(drop(x), train, drop, segment_ids, cache, step)
        x = self._norm(self.ln, x, train)
        # Tied head in float32 (tpunet's ``embed.attend`` on float32).
        logits = torch.matmul(x.float(), self.embed.weight.t())
        if cache is None:
            return logits
        if per_row:
            return logits, cache
        return logits, KVCache(cache.k, cache.v, cache.index + t)


def init_lm(model: TransformerLM, generator: torch.Generator) -> None:
    """Flax's initialisers: N(0, 0.02) token table and positions,
    lecun-normal Dense kernels with zero biases, unit/zero LayerNorms."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                _lecun_normal_(m.weight, m.weight.shape[1], generator)
                m.bias.zero_()
        model.embed.weight.normal_(0.0, 0.02, generator=generator)
        model.pos_embed.normal_(0.0, 0.02, generator=generator)


def create_lm(cfg, generator: torch.Generator) -> TransformerLM:
    """The LM of ``cfg``: ``vit_hidden``/``vit_depth``/``vit_heads``
    blocks over ``vocab_size`` tokens and ``max_seq_len`` positions, a
    causal core."""
    model = TransformerLM(vocab_size=cfg.vocab_size, hidden=cfg.vit_hidden,
                          depth=cfg.vit_depth, heads=cfg.vit_heads,
                          mlp_ratio=cfg.vit_mlp_ratio,
                          max_len=cfg.max_seq_len,
                          dropout_rate=cfg.dropout_rate,
                          attn_fn=make_attn_fn(cfg, causal=True),
                          dtype=getattr(torch, cfg.dtype))
    init_lm(model, generator)
    return model


def filter_logits(lg: torch.Tensor, *, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Truncate ``lg`` [..., V] for sampling: tokens outside the filters
    become -inf. Top-k first, then the nucleus over the renormalised
    post-top-k distribution (tpunet's sequential HF-warper semantics)."""
    v = lg.shape[-1]
    use_k = 0 < top_k < v
    use_p = 0.0 < top_p < 1.0
    if use_k or use_p:
        srt = torch.sort(lg, dim=-1, descending=True).values
    if use_k:
        lg = torch.where(lg >= srt[..., top_k - 1:top_k], lg, -torch.inf)
        srt = torch.where(torch.arange(v, device=lg.device) < top_k, srt,
                          -torch.inf)
    if use_p:
        # The smallest prefix of the sorted distribution whose mass
        # reaches top_p (the top token always survives).
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
        lg = torch.where(lg >= cutoff, lg, -torch.inf)
    return lg


@torch.no_grad()
def generate(model: TransformerLM, prompt: torch.Tensor, n_new: int, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             use_cache: bool = True) -> torch.Tensor:
    """Greedy (or sampled) generation from ``prompt`` [B, T0] int on the
    model's device; returns the buffer [B, T0 + n_new] int64. Temperature
    0 is greedy; above 0 it samples softmax(logits / T), optionally cut
    to the ``top_k`` tokens and/or the ``top_p`` nucleus.

    Default: the KV cache, the prompt prefilled through the same
    one-token step (tpunet's buffer-and-pick order: step i reads the
    token at i and writes its prediction at i + 1 unless that slot holds
    prompt). ``use_cache=False``: the full forward over a fixed-size
    buffer for every new token (causality makes the unwritten tail
    irrelevant). New token j draws the j-th sample from ``generator``
    (on the model's device; seeded 0 when None) on both paths."""
    device = model.pos_embed.device
    prompt = prompt.to(device=device, dtype=torch.long)
    b, t0 = prompt.shape
    total = t0 + n_new
    if total > model.max_len:
        raise ValueError(f"prompt + new tokens = {total} exceeds max_len "
                         f"{model.max_len}")
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def pick(lg: torch.Tensor) -> torch.Tensor:
        if temperature <= 0:
            return lg.argmax(-1)
        lg = filter_logits(lg / temperature, top_k=top_k, top_p=top_p)
        return torch.multinomial(torch.softmax(lg, -1), 1,
                                 generator=generator)[:, 0]

    buf = torch.zeros((b, total), dtype=torch.long, device=device)
    buf[:, :t0] = prompt
    if use_cache:
        cache = model.init_cache(b, total)
        for i in range(total - 1):
            logits, cache = model(buf[:, i:i + 1], pos_offset=i, cache=cache)
            if i + 1 >= t0:
                buf[:, i + 1] = pick(logits[:, 0])
        return buf
    for cur in range(t0, total):
        logits = model(buf)
        buf[:, cur] = pick(logits[:, cur - 1])
    return buf
