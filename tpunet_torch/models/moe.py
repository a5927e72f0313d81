"""Mixture-of-Experts MLP with expert parallelism: port of
``tpunet/models/moe.py``.

The semantics are tpunet's (ViT-MoE / Switch / GShard):

- router: a float32 Dense(E) over the tokens in float32 -> softmax probs
  -> the top-k experts a token (k = 2 by default), their gates
  renormalised over the k;
- capacity: each expert takes at most ``C = max(k, ceil(k*n/E * f))``
  (token, slot) pairs; a pair's position in its expert's buffer is its
  rank among that expert's pairs in slot-major token order (every
  token's first choice before any second choice), and pairs past C are
  dropped (their gate mass is lost, Switch's behaviour);
- the experts: ``gelu(x @ wi[e] + bi[e]) @ wo[e] + bo[e]`` in the
  activation dtype, GELU in its tanh form as the dense MLP computes it;
- the Shazeer load-balance term ``E * sum_e(frac_e * mean_prob_e)``,
  ``frac`` the share of the kept pairs that expert e took and
  ``mean_prob`` its mean router probability; the train step adds
  ``moe_aux_weight`` times the sum of the forward's terms to the loss.

The dispatch is computed with indices, not tpunet's one-hot einsums:
the kept (token, slot) pairs are gathered into the [E, C, d] capacity
buffers, the experts run as two ``torch.bmm``, and the outputs are
summed back per token with ``index_add``, weighted by their gates in
float32. At ViT-B/16's batch 128 (n = 25,216 tokens, C = 7,880 at E 8)
tpunet's [n, E, C] dispatch and combine tensors would be 6.4 GB each in
float32; here the largest routing tensor is [k*n, E] (the slot-major
positions), and the buffers are what the experts compute on anyway.
The results equal the einsums' (each buffer row holds one token, and a
token's output sums its k expert outputs; for k <= 2 the sum's order
cannot change a bit).

Expert parallelism shards the expert dim of ``wi``/``bi``/``wo``/``bo``
over the mesh's 'model' axis (``tpunet_torch.parallel.tp``); the router
stays replicated. The two lowerings (``--moe-dispatch``), on
``tpunet_torch.parallel.dist``'s counted collectives:

- ``replicated``: every 'model' rank routes all n of its tokens, runs
  its E/ep experts on their buffers, and the partial outputs are summed
  over 'model' (``reduce_from_group``);
- ``alltoall``: rank m routes its 1/ep slice of the tokens with the
  slice's capacity, one ``all_to_all`` ships each buffer row to the rank
  that holds its expert, the experts run on [E/ep, ep*C, d], a second
  ``all_to_all`` returns the outputs, and one ``all_gather``
  (``gather_from_group``) restores the replicated [n, d] output.

``auto`` resolves as tpunet's ``_resolved_dispatch``: ``alltoall`` when
the axis divides the tokens and the experts, else ``replicated``; an
explicit ``alltoall`` raises where ``auto`` would fall back.

The aux statistics (the kept pairs a expert and the summed
probabilities) are summed over the ranks of 'data' and 'seq' (and of
'model' under ``alltoall``), so the term is the global batch's scalar on
every rank, as tpunet's is. The routing scope is the rank's own tokens:
per ('data' x 'seq') shard and, under ``alltoall``, per 1/ep slice.
tpunet's ``alltoall`` routes the same way; its GSPMD ``replicated`` path
routes the global batch at one capacity, so with drops the port's
per-shard routing may drop other pairs than tpunet's (ROADMAP,
"Deviations kept on purpose"); with ample capacity the outputs are the
same.

Gradients across the ranks follow the Megatron convention of the
port's tensor parallelism: a replicated value's gradient is one loss's,
held alike on every rank of 'model'. The router's weights and the
tokens enter rank-specific work through ``copy_to_group`` (their
partial gradients summed over 'model'), partial outputs leave through
``reduce_from_group``, and the aux statistics are summed with
``all_reduce_sum`` over 'data' and 'seq' (every rank's loss holds the
global term) and with ``reduce_from_group`` over 'model'.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpunet_torch.parallel.dist import (SELF, all_reduce, all_reduce_sum,
                                        all_to_all, copy_to_group,
                                        gather_from_group, group_size,
                                        reduce_from_group)
from tpunet_torch.parallel.mesh import axis_group, axis_index

DISPATCHES = ("auto", "alltoall", "replicated")


class Routing(NamedTuple):
    """One routing's k*n (token, slot) pairs in slot-major order: each
    pair's token, expert, position in its expert's buffer, whether it
    was kept, and its gate (float32, differentiable; a dropped pair's
    counts for nothing); ``counts`` [E] the kept pairs a expert (the aux
    loss's ``frac`` numerators). Nothing here waits for the device: the
    kept pairs are a mask, not a list."""

    token: torch.Tensor
    expert: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    gate: torch.Tensor
    counts: torch.Tensor
    cap: int

    def rows(self, lo: int = 0, experts: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(buffer row of each pair, its gate, the number of rows) for the
        buffers of experts ``lo`` .. ``lo + experts`` (default all): a
        pair of another expert or a dropped one goes to the extra last
        row, which nothing reads, with gate 0."""
        e = self.counts.shape[0] if experts is None else experts
        mine = self.kept & (self.expert >= lo) & (self.expert < lo + e)
        trash = e * self.cap
        row = torch.where(mine, (self.expert - lo) * self.cap + self.pos,
                          trash)
        return row, self.gate * mine, trash


def capacity(k: int, n: int, e: int, capacity_factor: float) -> int:
    """tpunet's ``max(k, ceil(k * n / e * f))`` (``moe.py:178-179``)."""
    return max(k, math.ceil(k * n / e * capacity_factor))


def route(probs: torch.Tensor, k: int, e: int, cap: int) -> Routing:
    """Top-k capacity-bounded routing of ``probs`` [n, e] float32, tpunet's
    ``_route`` as indices: the top k experts a token, placed by
    :func:`place`."""
    return place(probs, torch.topk(probs, k, dim=-1).indices, e, cap)


def place(probs: torch.Tensor, expert: torch.Tensor, e: int,
          cap: int) -> Routing:
    """The routing of the choices ``expert`` [n, k] (slot j a token's j-th
    choice) under ``probs`` [n, e] float32: their gates renormalised over
    the k; each (token, slot) pair's position in its expert's buffer from
    a slot-major cumulative count in token order (slot-0 pairs take
    buffer space first); the pairs at position >= ``cap`` dropped."""
    n, k = expert.shape
    gate = probs.gather(1, expert)                             # [n, k]
    gate = gate / gate.sum(-1, keepdim=True)
    flat = expert.t().reshape(-1)                              # slot-major
    # The count runs along the last dim of an [e, k*n] one-hot (a scan
    # along the first dim of [k*n, e] runs one thread a column), which is
    # built by comparison (F.one_hot checks its indices' range on the
    # host, which waits for the device).
    onehot = torch.arange(e, device=probs.device)[:, None] == flat[None, :]
    pos = (onehot.cumsum(1, dtype=torch.int32) - 1).gather(
        0, flat[None, :])[0]
    kept = pos < cap
    counts = torch.zeros(e, device=probs.device).index_add(
        0, flat, kept.float())
    return Routing(torch.arange(n, device=probs.device).repeat(k), flat,
                   pos, kept, gate.t().reshape(-1), counts, cap)


def dispatch(tokens: torch.Tensor, row: torch.Tensor,
             rows: int) -> torch.Tensor:
    """The capacity buffers [rows, d] of the pairs' tokens ``tokens``
    [k*n, d] (``index_select``ed: its backward is an ``index_add``, a
    gather's a sort): row ``row[i]`` holds pair i's token, an unclaimed
    row zeros (the extra row ``rows`` of the dropped pairs is cut off)."""
    buf = tokens.new_zeros(rows + 1, tokens.shape[1])
    return buf.index_copy(0, row, tokens)[:rows]


def combine(out: torch.Tensor, r: Routing, row: torch.Tensor,
            gate: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """[n, d]: each token's expert outputs (rows ``row`` of the flat
    buffers ``out``, the extra row zeros) times their gates, summed in
    float32, in ``dtype``."""
    out = torch.cat([out, out.new_zeros(1, out.shape[1])])
    picked = (out.index_select(0, row).float()
              * gate.to(out.dtype).float()[:, None])
    y = picked.new_zeros(n, out.shape[1]).index_add(0, r.token, picked)
    return y.to(dtype)


def expert_ffn(xin: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
               wo: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """The experts on their buffers ``xin`` [e, c, d] (weights already in
    the activation dtype): ``gelu(x @ wi + bi) @ wo + bo`` a expert."""
    h = F.gelu(torch.bmm(xin, wi) + bi[:, None], approximate="tanh")
    return torch.bmm(h, wo) + bo[:, None]


def resolve_moe_dispatch(dispatch: str, *, ep: int, n_tokens: int,
                         n_experts: int) -> str:
    """Resolve a ``--moe-dispatch`` setting against the shapes, with
    tpunet's rules and messages: ``auto`` prefers ``alltoall`` when the
    expert axis divides the tokens and the experts and falls back to
    ``replicated``; an explicit ``alltoall`` raises instead; ``ep <= 1``
    is always replicated."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}; "
                         "expected auto|alltoall|replicated")
    if ep <= 1 or dispatch == "replicated":
        if dispatch == "alltoall":
            raise ValueError("moe_dispatch='alltoall' needs an expert "
                             "axis > 1 (mesh 'model')")
        return "replicated"
    ok = n_tokens % ep == 0 and n_experts % ep == 0
    if dispatch == "alltoall" and not ok:
        raise ValueError(
            f"moe_dispatch='alltoall' needs tokens ({n_tokens}) and "
            f"experts ({n_experts}) divisible by the expert axis ({ep})")
    return "alltoall" if ok else "replicated"


def _global_aux(counts: torch.Tensor, prob_sum: torch.Tensor, n: int,
                e: int, model_group=SELF,
                axes=("data", "seq")) -> torch.Tensor:
    """``e * sum(frac * mean_prob)`` of statistics summed over the mesh
    ``axes`` ('data' and 'seq'; none for a pipeline stage's microbatch)
    and over ``model_group``, whose ranks routed disjoint slices
    (``SELF`` when they routed the same tokens): ``counts`` [e] kept
    pairs, ``prob_sum`` [e] summed probabilities of this rank's ``n``
    tokens."""
    counts = all_reduce(counts.clone(), model_group)
    prob_sum = reduce_from_group(prob_sum, model_group)
    ranks = group_size(model_group)
    for g in (axis_group(a) for a in axes):
        counts = all_reduce(counts, g)
        prob_sum = all_reduce_sum(prob_sum, g)
        ranks *= group_size(g)
    frac = counts / counts.sum().clamp_min(1.0)
    return e * (frac * (prob_sum / (n * ranks))).sum()


def moe_apply(tokens: torch.Tensor, router_w: torch.Tensor,
              router_b: torch.Tensor, wi: torch.Tensor, bi: torch.Tensor,
              wo: torch.Tensor, bo: torch.Tensor, *, num_experts: int,
              top_k: int, capacity_factor: float, dtype: torch.dtype,
              ep_group=None, ep_impl: str = "replicated", aux: bool = True,
              aux_axes=("data", "seq")
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE core, tpunet's ``moe_apply``: ``tokens`` [n, d] -> ([n, d]
    in ``dtype``, aux or None). ``router_w`` [E, d] and ``router_b`` [E]
    are the router, which computes in float32. ``wi``/``bi``/``wo``/``bo``
    are this rank's experts in ``dtype``: all E, or E / ep of them under
    ``ep_group`` (the mesh's 'model' group; None is the whole world),
    whose ranks hold the same tokens; ``ep_impl`` picks the lowering
    (module docstring), as :func:`resolve_moe_dispatch` resolved it.
    ``aux``: compute the load-balance term (a training forward), its
    statistics summed over ``aux_axes`` ('data' and 'seq'; a pipeline
    stage routes each microbatch-shard on its own, tpunet's scope
    inside its pipeline's ``shard_map``)."""
    n, d = tokens.shape
    e = num_experts
    e_local = wi.shape[0]
    ep = e // e_local
    k = min(top_k, e)
    if ep > 1 and ep_impl == "alltoall":
        return _moe_apply_a2a(tokens, router_w, router_b, wi, bi, wo, bo,
                              e=e, k=k,
                              capacity_factor=capacity_factor, dtype=dtype,
                              group=ep_group, aux=aux, aux_axes=aux_axes)
    probs = torch.softmax(F.linear(tokens.float(), router_w.float(),
                                   router_b.float()), dim=-1)
    aux_term = None
    cap = capacity(k, n, e, capacity_factor)
    if ep > 1:
        # Every rank routes the same tokens alike: the gates' gradient
        # is partial (this rank's experts), the aux's whole.
        r = route(copy_to_group(probs, ep_group), k, e, cap)
        tokens = copy_to_group(tokens, ep_group)
    else:
        r = route(probs, k, e, cap)
    if aux:
        aux_term = _global_aux(r.counts, probs.sum(0), n, e,
                               axes=aux_axes)
    row, gate, rows = r.rows(axis_index("model") * e_local if ep > 1 else 0,
                             e_local)
    xin = dispatch(tokens.to(dtype).index_select(0, r.token), row, rows)
    out = expert_ffn(xin.view(e_local, cap, d), wi, bi, wo, bo)
    y = combine(out.reshape(rows, d), r, row, gate, n, dtype)
    if ep > 1:
        y = reduce_from_group(y, ep_group)
    return y, aux_term


def _moe_apply_a2a(tokens, router_w, router_b, wi, bi, wo, bo, *, e, k,
                   capacity_factor, dtype, group, aux,
                   aux_axes=("data", "seq")):
    """The GShard capacity-buffer ``all_to_all`` dispatch over ``group``
    (tpunet's ``_moe_apply_a2a``): ``tokens`` [n, d] alike on its ranks;
    returns ([n, d] alike on its ranks, aux)."""
    n, d = tokens.shape
    ep, e_local = e // wi.shape[0], wi.shape[0]
    if n % ep:
        raise ValueError(f"alltoall dispatch needs tokens ({n}) "
                         f"divisible by the expert axis ({ep})")
    n_l = n // ep
    m = axis_index("model")
    # The tokens and the router enter the slice's work: their partial
    # gradients are summed over the group.
    tokens_l = copy_to_group(tokens, group)[m * n_l:(m + 1) * n_l]
    probs = torch.softmax(F.linear(
        tokens_l.float(), copy_to_group(router_w.float(), group),
        copy_to_group(router_b.float(), group)), dim=-1)
    cap = capacity(k, n_l, e, capacity_factor)
    r = route(probs, k, e, cap)
    aux_term = (_global_aux(r.counts, probs.sum(0), n_l, e, group,
                            aux_axes) if aux else None)
    # Buffer rows [o*e_local*cap, (o+1)*e_local*cap) go to expert owner
    # o; what arrives is indexed (source rank, local expert).
    row, gate, rows = r.rows()
    xin = dispatch(tokens_l.to(dtype).index_select(0, r.token), row,
                   rows).view(e, cap, d)
    xin = all_to_all(xin, group, 0, 0)
    xin = (xin.view(ep, e_local, cap, d).transpose(0, 1)
           .reshape(e_local, ep * cap, d))
    out = expert_ffn(xin, wi, bi, wo, bo)
    out = (out.view(e_local, ep, cap, d).transpose(0, 1)
           .reshape(e, cap, d))
    out = all_to_all(out, group, 0, 0)
    y = combine(out.reshape(rows, d), r, row, gate, n_l, dtype)
    return gather_from_group(y, group), aux_term


class MoeMlp(nn.Module):
    """The sparse MLP of a block (tpunet's ``MoeMlp``): the float32 router
    ``router`` (a Dense [d -> E]: ``weight`` [E, d], ``bias`` [E]) and the
    experts ``wi`` [E, d, h], ``bi`` [E, h], ``wo`` [E, h, d], ``bo``
    [E, d], in tpunet's layouts. The encoder computes with it
    (``tpunet_torch.models.vit.Encoder._moe``)."""

    def __init__(self, c: int, mlp_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dispatch: str = "auto"):
        super().__init__()
        from tpunet_torch.models.vit import Dense
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dispatch = capacity_factor, dispatch
        self.router = Dense(c, num_experts)
        self.wi = nn.Parameter(torch.empty(num_experts, c, mlp_dim))
        self.bi = nn.Parameter(torch.zeros(num_experts, mlp_dim))
        self.wo = nn.Parameter(torch.empty(num_experts, mlp_dim, c))
        self.bo = nn.Parameter(torch.zeros(num_experts, c))

    def init_(self, generator: torch.Generator) -> None:
        """tpunet's initialisers: the router N(0, 0.02) with a zero bias,
        ``wi``/``wo`` He-scaled truncated normals over their fan-in
        (flax's ``variance_scaling(2.0, 'fan_in', 'truncated_normal')``:
        fan-in d of [E, d, h] and h of [E, h, d]), zero biases."""
        with torch.no_grad():
            self.router.weight.normal_(0.0, 0.02, generator=generator)
            self.router.bias.zero_()
            for w in (self.wi, self.wo):
                std = math.sqrt(2.0 / w.shape[1]) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            self.bi.zero_()
            self.bo.zero_()
