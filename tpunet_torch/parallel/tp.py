"""Which tensor of the train state is split over which mesh axis: port
of ``tpunet/parallel/tp.py``.

tpunet matches regexes against the 'a/b/c' paths of its state tree and
hands the resulting ``PartitionSpec``s to GSPMD. The port matches the
same rules against ``<tree>/<state_dict key>`` paths, where the tree is
``params``, ``mu``/``nu`` (the Adam moments) or ``ema`` (the EMA
copies), and resolves each leaf to one :class:`Shard`, (dim, axis,
interleave), or None for a replicated leaf. :func:`layout` gives the
table, parameter name -> (the parameter's shard, the moments' shard),
that the train state, the checkpoint and the tests read; the EMA copies
are sharded as their parameters.

The Megatron rules (tpunet's ``VIT_TP_RULES``) for the ViT family and
the LM, in the port's layouts (``Dense.weight`` is [out, in]):
``attn.qkv`` and ``mlp.fc1`` are column-parallel (weight and bias split
on dim 0, the outputs), ``attn.out`` and ``mlp.fc2`` row-parallel (the
weight split on dim 1, the inputs; the bias replicated and added once
after the reduce). tpunet cuts ``qkv``'s 3C columns contiguously, which
GSPMD can compute from; an explicit split must give each rank whole
heads of each of q, k and v, so the qkv shard has ``interleave`` 3: the
3C rows are (q, k, v) x heads x head_dim, and rank r takes its heads of
each of the three. An MoE block's experts (``moe.wi``/``bi``/``wo``/
``bo``, [E, ...]) split their expert dim over 'model' (expert
parallelism) and its router stays replicated, as in tpunet; with FSDP
they keep that split and FSDP takes the rest, with 'model' of 1 FSDP
splits them as any leaf. MobileNetV2 takes no TP rule (``rules_for`` gives
``()``, as tpunet's does: at 2.2M parameters a CNN gains nothing).

ZeRO-1 (``ZERO1_RULES``) splits the moments on dim 0 over 'data'; FSDP
(``FSDP_RULES``) splits the parameters, the moments and the EMA copies
on each leaf's largest dim that the data axis divides (``_fsdp_spec``;
the port's [out, in] and OIHW layouts pick other dims than tpunet's
[in, out] and HWIO, which is allowed: the resident bytes a rank are 1/N
either way). Rules match in order and the first that fits wins, so a
TP-matched leaf keeps its 'model' split and FSDP takes the rest; a rule
whose dim the axis does not divide is passed over, and a leaf that no
rule fits is replicated.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch


class Shard(NamedTuple):
    """A leaf split in equal pieces along ``dim`` over ``axis``; with
    ``interleave`` k the dim is k blocks, each split alike (qkv: k 3)."""

    dim: int
    axis: str
    interleave: int = 1


FSDP = "FSDP"  # the sentinel: resolve per leaf (largest divisible dim)
Rule = Tuple[str, object]   # (regex, Shard | FSDP)
Rules = Sequence[Rule]

VIT_TP_RULES: Rules = (
    (r"attn\.qkv\.(weight|bias)$", Shard(0, "model", 3)),   # column parallel
    (r"attn\.out\.weight$", Shard(1, "model")),              # row parallel
    (r"mlp\.fc1\.(weight|bias)$", Shard(0, "model")),        # column parallel
    (r"mlp\.fc2\.weight$", Shard(1, "model")),               # row parallel
    (r"moe\.(wi|bi|wo|bo)$", Shard(0, "model")),             # expert parallel
)

# The pipelined models (vit_pp, lm_pp): a stage's blocks are the modules
# its rank holds (tpunet's P('pipe') on the stacked leading dim is module
# ownership here, ``tpunet_torch.parallel.pp.PipePlan``); on a 'model'
# axis only the MoE experts split (tpunet's P('pipe', 'model') expert
# stacks, EP x PP), and the routers and every dense leaf stay whole on
# every 'model' rank (tpunet/parallel/tp.py:53-74).
PP_RULES: Rules = (
    (r"moe\.(wi|bi|wo|bo)$", Shard(0, "model")),             # expert parallel
)

ZERO1_RULES: Rules = (
    (r"^(mu|nu)/", Shard(0, "data")),
)

FSDP_RULES: Rules = (
    (r"^params/", FSDP),
    (r"^ema/", FSDP),
    (r"^(mu|nu)/", FSDP),
)


def _fsdp_spec(shape: Sequence[int], n: int) -> Optional[Shard]:
    """The largest dim of ``shape`` that ``n`` divides, split over
    'data'; None (replicated) for a scalar, ``n`` <= 1, or no such dim."""
    if n <= 1 or not shape:
        return None
    best = max((d for d in range(len(shape)) if shape[d] % n == 0),
               key=lambda d: shape[d], default=None)
    if best is None or shape[best] < n:
        return None
    return Shard(best, "data")


def rules_for(cfg, mesh_shape: Optional[Dict[str, int]] = None,
              zero1: bool = False, fsdp: bool = False) -> Rules:
    """The rules of the model of ``cfg`` (a ModelConfig): the Megatron
    rules for the ViT family and the LM, the expert split alone for the
    pipelined models, none for MobileNetV2.
    ``mesh_shape`` prunes rules whose axis has size 1; ``fsdp`` appends
    FSDP_RULES, else ``zero1`` ZERO1_RULES (FSDP subsumes ZeRO-1)."""
    name = cfg.name
    rules: Rules = (PP_RULES if name in ("vit_pp", "lm_pp") else
                    VIT_TP_RULES if name == "lm" or name.startswith("vit")
                    else ())
    if mesh_shape is not None:
        rules = tuple((rx, s) for rx, s in rules
                      if mesh_shape.get(s.axis, 1) > 1)
    if fsdp:
        return tuple(rules) + FSDP_RULES
    if zero1:
        return tuple(rules) + ZERO1_RULES
    return tuple(rules)


def _spec_for(path: str, shape: Sequence[int], mesh_shape: Dict[str, int],
              rules) -> Optional[Shard]:
    """The first rule that matches ``path`` and fits ``shape`` on this
    mesh, resolved; None (replicated) when none does."""
    for rx, spec in rules:
        if re.search(rx, path) is None:
            continue
        if spec == FSDP:
            return _fsdp_spec(shape, mesh_shape.get("data", 1))
        n = mesh_shape.get(spec.axis, 1)
        if (spec.dim >= len(shape) or n <= 1
                or shape[spec.dim] % (n * spec.interleave)):
            continue  # does not fit: later rules get their chance
        return spec
    return None


class LeafLayout(NamedTuple):
    """A parameter's split at rest (and its EMA copy's) and its Adam
    moments'."""

    param: Optional[Shard]
    moments: Optional[Shard]


def layout(named_shapes: Dict[str, Sequence[int]], cfg,
           mesh_shape: Dict[str, int], zero1: bool = False,
           fsdp: bool = False) -> Dict[str, LeafLayout]:
    """The table: for each parameter name (a ``state_dict`` key of the
    full model) and its full shape, where it and its moments rest."""
    rules = rules_for(cfg, mesh_shape, zero1=zero1, fsdp=fsdp)
    return {name: LeafLayout(
        _spec_for(f"params/{name}", shape, mesh_shape, rules),
        _spec_for(f"mu/{name}", shape, mesh_shape, rules))
        for name, shape in named_shapes.items()}


def compute_spec(leaf: LeafLayout) -> Optional[Shard]:
    """The split a parameter computes with: its 'model' split, if any
    (FSDP's 'data' split is gathered at the step's start)."""
    return leaf.param if leaf.param is not None and \
        leaf.param.axis == "model" else None


# -- splitting and joining ------------------------------------------------

def pieces(t: torch.Tensor, spec: Shard, n: int) -> torch.Tensor:
    """``t`` split as ``spec`` says into ``n`` pieces, stacked on a new
    dim 0: [n, *piece shape]. Piece r of an interleaved dim takes block
    r of each of the ``interleave`` blocks."""
    d, k = spec.dim, spec.interleave
    x = t.unflatten(d, (k, n, t.shape[d] // (k * n)))   # [.., k, n, l, ..]
    x = x.movedim(d + 1, 0)                             # [n, .., k, l, ..]
    return x.flatten(d + 1, d + 2)


def piece(t: torch.Tensor, spec: Shard, n: int, r: int) -> torch.Tensor:
    """Piece ``r`` of ``n`` of ``t`` (a copy)."""
    return pieces(t, spec, n)[r].clone()


def join(stacked: torch.Tensor, spec: Shard) -> torch.Tensor:
    """The inverse of :func:`pieces`: [n, *piece shape] -> the whole."""
    n, d, k = stacked.shape[0], spec.dim, spec.interleave
    x = stacked.unflatten(d + 1, (k, stacked.shape[d + 1] // k))
    x = x.movedim(0, d + 1)                             # [.., k, n, l, ..]
    return x.flatten(d, d + 2)
