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
rank, so no mask is drawn on the host and copied. Under data parallelism
each rank therefore draws its own masks: with dropout above 0, N ranks
do not repeat the masks of one rank on the same global batch (they
already differ between the CPU and the card); at dropout 0 they compute
the same step. In eval mode the weights cast to
``dtype`` are computed once and reused until a parameter changes.

The blocks' arithmetic lives in :class:`Encoder`, which the LM
(``tpunet_torch.models.lm``) shares, with tpunet's module-clock decode
step (:func:`decode_attend` against a :class:`KVCache`). Not ported: the
serving engine's per-row positions, ``active`` gates and ``PagedKV``
(ROADMAP Queue A item 5), MoE blocks and the sequence-parallel cores
(item 8), block remat (item 2b); the config refuses them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpunet_torch.ops.attention import blockwise_attention, dense_attention
from tpunet_torch.ops.flash import flash_attention
from tpunet_torch.parallel.dist import process_index

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
    """Pre-LN block: x + Attn(LN(x)); x + Mlp(LN(x))."""

    def __init__(self, c: int, mlp_dim: int):
        super().__init__()
        self.ln1 = LayerNorm(c)
        self.attn = Attention(c)
        self.ln2 = LayerNorm(c)
        self.mlp = MlpBlock(c, mlp_dim)


class PatchEmbed(nn.Module):
    """The p x p stride-p patch convolution's weight [hidden, 3, p, p]."""

    def __init__(self, hidden: int, patch: int, channels: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hidden, channels, patch, patch))
        self.bias = nn.Parameter(torch.zeros(hidden))


@dataclasses.dataclass(frozen=True)
class KVCache:
    """The decode cache of a decoder stack, passed in and returned: per
    layer the cached keys and values [B, total, H, D] in the activation
    dtype, and ``index``, the position the next token is written at
    (tpunet's ``cached_k``/``cached_v``/``cache_index``). A decode step
    writes its token's K/V into the tensors in place and returns the
    cache advanced by one; the cache it was given shares those tensors
    and is stale afterwards."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    index: int = 0

    @classmethod
    def zeros(cls, depth: int, batch: int, total: int, heads: int,
              head_dim: int, dtype: torch.dtype, device) -> "KVCache":
        def make():
            return tuple(torch.zeros(batch, total, heads, head_dim,
                                     dtype=dtype, device=device)
                         for _ in range(depth))
        return cls(make(), make(), 0)


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cached_k: torch.Tensor, cached_v: torch.Tensor,
                  index: int) -> torch.Tensor:
    """One token's attention against the cache, tpunet's module-clock
    ``_decode_attend`` (``tpunet/models/vit.py:159-214``): k and v
    [B, 1, H, D] are written at ``index`` of the cache (in place), then
    q attends to positions 0..index. Scores in float32 from the
    activation-dtype q and cached K, times D^-1/2; softmax in float32;
    p kept in float32 against V; the result cast to q's dtype. The
    positions past ``index`` that tpunet masks to -1e30 (probability
    exactly 0) are left out of the sums."""
    if q.shape[1] != 1:
        raise ValueError(f"decode processes one token per call, got "
                         f"{q.shape[1]}")
    if index >= cached_k.shape[1]:
        raise ValueError(f"decode position {index} is past the cache's "
                         f"{cached_k.shape[1]} positions")
    cached_k[:, index] = k[:, 0]
    cached_v[:, index] = v[:, 0]
    kf = cached_k[:, :index + 1].float()
    vf = cached_v[:, :index + 1].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[-1] ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


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
        # id(parameter) -> (source state, parameter, cast copy); eval only.
        self._consts: Dict[int, tuple] = {}

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

    def _linear(self, dense: Dense, x: torch.Tensor, train: bool):
        return F.linear(x, self._cast(dense.weight, train),
                        self._cast(dense.bias, train))

    def _norm(self, ln: LayerNorm, x: torch.Tensor, train: bool):
        return F.layer_norm(x, x.shape[-1:], self._cast(ln.weight, train),
                            self._cast(ln.bias, train), LN_EPSILON)

    def _dropout(self, train: bool, generator: Optional[torch.Generator],
                 device: torch.device) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
        """The step's dropout: x -> x / keep where a Bernoulli(keep) draw
        is 1, else 0 (flax's ``nn.Dropout``); the identity in eval mode or
        at rate 0."""
        rate = self.dropout_rate
        if not train or rate == 0.0:
            return lambda x: x
        if generator is None:
            raise ValueError("train mode with dropout needs a generator")
        seed = int(torch.randint(0, 2**62, (1,), generator=generator))
        # Rank 0 keeps the draw; the others step away from it by a large
        # odd constant (2^64 / golden ratio).
        seed = (seed + process_index() * 0x9E3779B97F4A7C15) % 2**63
        bits = torch.Generator(device=device).manual_seed(seed)
        keep = 1.0 - rate

        def drop(x):
            mask = torch.empty_like(x).bernoulli_(keep, generator=bits)
            return x * mask / keep
        return drop

    def _attention(self, attn: Attention, x: torch.Tensor, train: bool,
                   segment_ids: Optional[torch.Tensor] = None,
                   kv: Optional[tuple] = None):
        """Self-attention of ``x`` [B,T,C]: the core over q, k, v views
        of the fused projection, with ``segment_ids`` [B,T] as both the
        query and the key segments (tpunet's ``segment_ids=(seg, seg)``);
        or, with ``kv`` = (cached K, cached V, index), one decode step
        against the cache, which skips the core."""
        b, t, c = x.shape
        qkv = self._linear(attn.qkv, x, train)
        q, k, v = qkv.view(b, t, 3, self.heads, c // self.heads).unbind(2)
        if kv is not None:
            y = decode_attend(q, k, v, *kv)
        elif segment_ids is not None:
            y = self.attn_fn(q, k, v, segment_ids=(segment_ids, segment_ids))
        else:
            y = self.attn_fn(q, k, v)
        return self._linear(attn.out, y.reshape(b, t, c), train)

    def _mlp(self, mlp: MlpBlock, x: torch.Tensor, train: bool):
        y = F.gelu(self._linear(mlp.fc1, x, train), approximate="tanh")
        return self._linear(mlp.fc2, y, train)

    def _encode(self, x: torch.Tensor, train: bool, drop,
                segment_ids: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        """The blocks over ``x``: x + drop(Attn(LN(x))); x +
        drop(Mlp(LN(x))), against ``cache`` when one is given."""
        for i, blk in enumerate(self.blocks):
            kv = None if cache is None else (cache.k[i], cache.v[i],
                                             cache.index)
            x = x + drop(self._attention(blk.attn,
                                         self._norm(blk.ln1, x, train),
                                         train, segment_ids, kv))
            x = x + drop(self._mlp(blk.mlp, self._norm(blk.ln2, x, train),
                                   train))
        return x


class ViT(Encoder):
    """ViT backbone + linear head for ``image_size`` square images."""

    HEAD_KEYS = ("classifier.weight", "classifier.bias")

    def __init__(self, num_classes: int = 10, image_size: int = 224,
                 patch_size: int = 16, hidden: int = 192, depth: int = 6,
                 heads: int = 3, mlp_ratio: float = 4.0,
                 dropout_rate: float = 0.0,
                 attn_fn: AttnFn = dense_attention,
                 dtype: torch.dtype = torch.bfloat16):
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
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, int(hidden * mlp_ratio)) for _ in range(depth))
        self.ln = LayerNorm(hidden)
        self.classifier = Dense(hidden, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        x = x + self._cast(self.pos_embed, train)
        drop = self._dropout(train, generator, x.device)
        x = self._encode(drop(x), train, drop)
        x = self._norm(self.ln, x, train).mean(dim=1)  # mean pool over tokens
        return self._linear(self.classifier, x, train).float()


def make_attn_fn(cfg, causal: bool = False) -> AttnFn:
    """The configured attention core, ``causal`` for the LM: ``auto``
    and ``flash`` give the flash kernels (``attention_block`` is their
    TPU block size, not read by the CUDA kernels), ``dense`` the plain
    softmax, ``blockwise`` the chunked online softmax over
    ``attention_block`` keys."""
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
    if cfg.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} (sequence parallelism over a mesh) "
            "is not ported to tpunet_torch yet; it comes with ROADMAP "
            "Queue A item 8")
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
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
        model.classifier.weight.zero_()


def create_vit(cfg, image_size: int, generator: torch.Generator) -> ViT:
    """The ViT of ``cfg``: a preset's (patch, hidden, depth, heads), or
    the ``vit_*`` fields for ``vit``."""
    patch, hidden, depth, heads = VIT_PRESETS.get(cfg.name, (
        cfg.vit_patch, cfg.vit_hidden, cfg.vit_depth, cfg.vit_heads))
    model = ViT(num_classes=cfg.num_classes, image_size=image_size,
                patch_size=patch, hidden=hidden, depth=depth, heads=heads,
                mlp_ratio=cfg.vit_mlp_ratio, dropout_rate=cfg.dropout_rate,
                attn_fn=make_attn_fn(cfg), dtype=getattr(torch, cfg.dtype))
    init_vit(model, generator)
    return model
