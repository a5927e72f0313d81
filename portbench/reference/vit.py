"""The Vision Transformer (Dosovitskiy et al., arXiv:2010.11929), written
out plainly for the reference, in the port's variant: pre-LN blocks over
non-overlapping patches, no class token, the tokens mean-pooled after
the final LayerNorm (the paper's global-average-pooling head, its
Appendix D.3), LayerNorm epsilon 1e-6, GELU in its tanh form, dropout
after the position embedding, after each attention output and after
each MLP. Parameters by the port's names (``patch_embed``,
``pos_embed``, ``blocks.<i>.{ln1, attn.qkv, attn.out, ln2, mlp.fc1,
mlp.fc2}``, ``ln``, ``classifier``), Dense kernels [out, in]; float32
with ``cast`` where the port keeps its activation dtype.

Attention is the textbook softmax(QK^T / sqrt(d)) V in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
# 2^64 over the golden ratio: the dropout seed's step between data ranks.
RANK_STRIDE = 0x9E3779B97F4A7C15


def dims(cfg: dict) -> Tuple[int, int, int, int, int]:
    """(patch, hidden, depth, heads, mlp) of the configuration."""
    hidden = cfg["hidden_size"]
    return (cfg["patch_size"], hidden, cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["intermediate_size"])


def tokens(cfg: dict, image_size: int) -> int:
    return (image_size // cfg["patch_size"]) ** 2


def param_spec(cfg: dict, image_size: int) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of every parameter; std 0 is a zero, -1 a one.
    LeCun-normal kernels (std 1/sqrt(fan in)) with zero biases, N(0,
    0.02) positions, unit and zero LayerNorms; the classifier LeCun-normal
    too, so that every leaf has a gradient at the first step."""
    p, c, depth, _, mlp = dims(cfg)
    spec: List[Tuple[str, tuple, float]] = []

    def dense(name, cin, cout):
        spec.extend([(f"{name}.weight", (cout, cin), cin ** -0.5),
                     (f"{name}.bias", (cout,), 0.0)])

    def ln(name):
        spec.extend([(f"{name}.weight", (c,), -1.0),
                     (f"{name}.bias", (c,), 0.0)])

    spec.extend([("patch_embed.weight", (c, 3, p, p), (3 * p * p) ** -0.5),
                 ("patch_embed.bias", (c,), 0.0),
                 ("pos_embed", (1, tokens(cfg, image_size), c), 0.02)])
    for i in range(depth):
        b = f"blocks.{i}"
        ln(f"{b}.ln1")
        dense(f"{b}.attn.qkv", c, 3 * c)
        dense(f"{b}.attn.out", c, c)
        ln(f"{b}.ln2")
        dense(f"{b}.mlp.fc1", c, mlp)
        dense(f"{b}.mlp.fc2", mlp, c)
    ln("ln")
    dense("classifier", c, cfg["num_classes"])
    return spec


def draw(generator: torch.Generator, n: int, cfg: dict, device: torch.device,
         image_size: int, data_rank: int = 0) -> Dict[str, torch.Tensor]:
    """The step's draws after the augmentation's: one 62-bit seed from the
    step generator, stepped by the data rank, seeds a generator on the
    activations' device, from which the forward's dropout masks are drawn
    in order (after the embedding, then each block's attention and MLP
    outputs), each a Bernoulli(1 - rate) draw at [n, tokens, hidden] in
    the activation dtype, as the port draws them."""
    rate = cfg["dropout_rate"]
    if rate <= 0:
        return {}
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    seed = (seed + data_rank * RANK_STRIDE) % 2 ** 63
    bits = torch.Generator(device=device).manual_seed(seed)
    _, c, depth, _, _ = dims(cfg)
    shape = (n, tokens(cfg, image_size), c)
    dtype = getattr(torch, cfg["dtype"])
    masks = [torch.empty(shape, dtype=dtype, device=device).bernoulli_(
        1.0 - rate, generator=bits) for _ in range(1 + 2 * depth)]
    return {"masks": masks}


def _ln(x, P, name, cast):
    return cast(F.layer_norm(x, x.shape[-1:], cast(P[f"{name}.weight"]),
                             cast(P[f"{name}.bias"]), LN_EPS))


def _dense(x, P, name, cast):
    return cast(F.linear(x, cast(P[f"{name}.weight"]),
                         cast(P[f"{name}.bias"])))


def forward(P: Dict[str, torch.Tensor], x: torch.Tensor,
            rand: Dict[str, torch.Tensor], cast: Callable,
            cfg: dict) -> torch.Tensor:
    """Float32 logits [B, classes] of normalised images [B,S,S,3]."""
    p, c, depth, heads, _ = dims(cfg)
    n, s = x.shape[0], x.shape[1]
    g = s // p
    x = cast(x)                                         # [n, S, S, 3]
    x = x.reshape(n, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(n, g * g, 3 * p * p)                  # (c, i, j) a patch
    w = P["patch_embed.weight"]
    x = cast(F.linear(x, cast(w.reshape(w.shape[0], -1)),
                      cast(P["patch_embed.bias"])))
    x = cast(x + cast(P["pos_embed"]))
    masks = iter(rand.get("masks", ()))
    keep = 1.0 - cfg["dropout_rate"]

    def drop(t):
        m = next(masks, None)
        return t if m is None else cast(t * m.float() / keep)

    x = drop(x)
    t = x.shape[1]
    for i in range(depth):
        b = f"blocks.{i}"
        qkv = _dense(_ln(x, P, f"{b}.ln1", cast), P, f"{b}.attn.qkv", cast)
        q, k, v = qkv.view(n, t, 3, heads, c // heads).unbind(2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(c // heads)
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)
        x = cast(x + drop(_dense(cast(a).reshape(n, t, c), P,
                                 f"{b}.attn.out", cast)))
        h = _dense(_ln(x, P, f"{b}.ln2", cast), P, f"{b}.mlp.fc1", cast)
        h = cast(F.gelu(h, approximate="tanh"))
        x = cast(x + drop(_dense(h, P, f"{b}.mlp.fc2", cast)))
    x = cast(_ln(x, P, "ln", cast).mean(dim=1))
    return _dense(x, P, "classifier", cast).float()


def train_flops_per_sample(cfg: dict, image_size: int) -> float:
    """The port's ``train_flops_per_unit`` for the ViT, copied (6N a token
    plus 12 * L * T * H for the attention scores), at the tokens this
    variant has: the patches, with no class token."""
    _, c, depth, _, _ = dims(cfg)
    n = sum(math.prod(shape) for _, shape, _ in param_spec(cfg, image_size))
    t = tokens(cfg, image_size)
    return t * (6.0 * n + 12.0 * depth * t * c)


def op_calls(cfg: dict, batch: int, image_size: int) -> Dict[str, list]:
    """The hand-kernel ops of one training step, by family: ``flash``
    (b, t, heads, head_dim), one attention a block."""
    _, c, depth, heads, _ = dims(cfg)
    t = tokens(cfg, image_size)
    return {"flash": [(batch, t, heads, c // heads)] * depth}
