"""Train state and optimization stack, port of ``tpunet/train/state.py``.

The reference's stack is CrossEntropyLoss + Adam(lr=1e-4) +
StepLR(step_size=10, gamma=0.1). tpunet writes StepLR as an optax
piecewise-constant schedule over steps; :func:`lr_schedule` is that
schedule as a plain function of the 0-based update index, and the train
step sets each update's learning rate from it. The update at index
``10 * steps_per_epoch`` is the first at the decayed rate, as with
torch's per-epoch ``StepLR``. ``clip_norm`` > 0 puts optax's
``clip_by_global_norm`` before the optimizer, as tpunet chains it.

Parameter EMA (``ema_decay`` > 0, tpunet's ``ema_params`` and
``ema_batch_stats``): copies of the parameters and of the floating
buffers (BN running statistics), made at the start, are moved after
every update by ``e = d*e + (1-d)*p`` over the post-update values (one
``torch._foreach_lerp_``); :meth:`TrainState.ema_weights` puts them in
the model for eval and the best checkpoint.

Sharded state (:class:`Sharding`, the mesh of ``MeshConfig``; tpunet's
``state_shardings`` and ``gather_params``): the table of
``tpunet_torch.parallel.tp.layout`` says where each parameter and its
moments rest. A parameter whose moments are split over 'data' gets a
*master*, its piece, on which the optimizer runs (Adam on 1/N of the
moments); the others are their own masters. Under FSDP the master is
the parameter at rest: the model's tensor is empty between steps,
:meth:`Sharding.gather` fills it at the step's start (one all-gather
over 'data' for all of them), and it is emptied again after the update;
the EMA copies follow the masters, so they rest sharded too. Under
ZeRO-1 the parameter stays whole and is refreshed from the updated
masters by one all-gather. Under sequence parallelism each rank's
gradients are partial sums over its tokens: they are summed over 'seq'
first (:func:`sum_over_seq`). The gradients are then reduced over 'data':
one all-reduce for the leaves whose moments are whole, one
reduce-scatter for the split ones, each in one flat buffer a dtype;
before them, on a 'model' axis, one all-reduce averages the replicated
leaves' gradients over its group, which its ranks compute alike but
for the order of CUDA's atomic accumulations, and each leaf's gap to
that mean is kept (:meth:`Sharding.replicated_gaps`). The global clip
norm sums the squares of the pieces over their axis and counts a
replicated leaf once. The checkpoint's model, optimizer and EMA
entries are gathered whole (:meth:`TrainState.full_model_state` ...) and
cut again on load, so a resume may take another mesh.

Pipeline parallelism (the 'pipe' axis, ``vit_pp``/``lm_pp``): a rank's
model holds its stage's blocks (the model's ``pp`` plan), and its
optimizer, moments and EMA copies only those and the leaves every stage
keeps (embeddings, positions, the final LayerNorm, the head). Those
replicated leaves get their gradient on some stages only (the LM's tied
table on stage 0 and the last stage), so their gradients are summed over
'pipe' (zeros where a stage has none, one flat all-reduce a dtype)
before the 'data' reduction, and every stage updates the same values
(:meth:`Sharding.replicated_gaps` holds the 'model' copies alike, as
before). The clip's global norm adds each stage's block leaves over
'pipe'. ZeRO-1 and FSDP split a stage's leaves over the 'data' ranks of
that stage. The checkpoint's entries are gathered from every stage into
the whole model's state in plain layer order (one all-gather over 'pipe'
a dtype, every stage holding the same shapes) and a restore keeps this
stage's part, so a pipeline checkpoint reads as an unpipelined one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import torch

from tpunet_torch.config import OptimConfig
from tpunet_torch.models.convert import (gather_state_dict, gather_tensor,
                                         load_state_dict, shard_state_dict,
                                         shard_tensor)
from tpunet_torch.obs.spans import span
from tpunet_torch.parallel import dist
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size
from tpunet_torch.parallel.tp import LeafLayout, Shard, join, pieces

Schedule = Callable[[int], float]


def lr_schedule(cfg: OptimConfig, steps_per_epoch: int,
                epochs: int) -> Schedule:
    """Step-indexed learning rate: ``schedule(t)`` is the rate of update
    ``t`` (0-based).

    ``step``: the base rate times ``gamma`` for every boundary at
    ``step_size_epochs``, ``2*step_size_epochs``, ... epochs (up to
    ``epochs``) with ``t >= boundary``; ``cosine``: decays to 0 over the
    steps after warmup; ``constant``. A linear warmup over
    ``warmup_epochs`` (fractional allowed) from 0 comes first, and the
    base schedule's clock starts when it ends (optax.join_schedules)."""
    total = steps_per_epoch * epochs
    warm = int(round(cfg.warmup_epochs * steps_per_epoch))
    lr = cfg.learning_rate
    if cfg.schedule == "step":
        bounds = [e * steps_per_epoch
                  for e in range(cfg.step_size_epochs, epochs + 1,
                                 cfg.step_size_epochs)]

        def base(t: int) -> float:
            v = lr
            for b in bounds:
                if t >= b:
                    v *= cfg.gamma
            return v
    elif cfg.schedule == "cosine":
        decay = max(1, total - warm)

        def base(t: int) -> float:
            frac = min(max(t, 0), decay) / decay
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    elif cfg.schedule == "constant":
        def base(t: int) -> float:
            return lr
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}; "
                         "expected step|cosine|constant")
    if warm <= 0:
        return base

    def warmed(t: int) -> float:
        if t < warm:
            return lr * max(t, 0) / warm
        return base(t - warm)
    return warmed


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: OptimConfig) -> torch.optim.Optimizer:
    """The optimizer of tpunet's ``make_optimizer``: Adam (with
    ``weight_decay`` 0), else AdamW with decoupled decay, or SGD with
    momentum 0.9. eps sits outside the square root, as in optax. The
    learning rate is set before every update from :func:`lr_schedule`."""
    params = list(params)
    if cfg.name == "adam" and cfg.weight_decay == 0.0:
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(cfg.b1, cfg.b2), eps=cfg.eps)
    if cfg.name in ("adam", "adamw"):
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                                 weight_decay=cfg.weight_decay)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=0.9)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    every gradient times ``max_norm / norm`` when the L2 norm of all of
    them together is at least ``max_norm``, else unchanged (no epsilon
    and no clamp, unlike ``torch.nn.utils.clip_grad_norm_``). ``norm``:
    the global norm when ``grads`` are pieces of it (sharded state)."""
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


def _flat_groups(tensors: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    """Indices of ``tensors`` by dtype, for one flat buffer each."""
    out: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def mean_over_group(grads: List[torch.Tensor], group, n: int,
                    gaps: bool = False) -> Optional[List[torch.Tensor]]:
    """Replace each of ``grads`` by its mean over the ``n`` ranks of
    ``group``, in place: one all-reduce of one flat buffer a dtype. With
    ``gaps``, returns for each gradient its largest |own - mean| over
    the mean's largest |entry| (0-d float32 on its device, no host
    sync): 0 where the ranks held the same gradient."""
    out: Optional[List[torch.Tensor]] = [None] * len(grads) if gaps else None
    for ids in _flat_groups(grads).values():
        gs = [grads[j] for j in ids]
        flat = dist.all_reduce(torch.cat([g.reshape(-1) for g in gs]), group)
        flat.div_(n)
        means = [c.view_as(g) for c, g in zip(
            flat.split([g.numel() for g in gs]), gs)]
        if gaps:
            inf = float("inf")
            diff = torch._foreach_norm(torch._foreach_sub(gs, means), inf)
            scale = torch._foreach_norm(means, inf)
            for j, d, s in zip(ids, diff, scale):
                out[j] = d.float() / s.float().clamp_min(
                    torch.finfo(torch.float32).tiny)
        torch._foreach_copy_(gs, means)
    return out


def sum_over_group(grads: List[torch.Tensor], group) -> None:
    """Sum ``grads`` over the ranks of ``group`` in place, one flat
    all-reduce a dtype."""
    for ids in _flat_groups(grads).values():
        gs = [grads[j] for j in ids]
        flat = dist.all_reduce(torch.cat([g.reshape(-1) for g in gs]),
                               group)
        torch._foreach_copy_(gs, [c.view_as(g) for c, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


def sum_over_seq(grads: List[torch.Tensor]) -> None:
    """Sequence parallelism: each rank of a 'seq' group holds the
    gradient of its share of the tokens (a partial sum, not a copy), so
    the group's gradients are summed in place. Nothing to do without a
    'seq' axis."""
    if axis_size("seq") > 1:
        sum_over_group(grads, axis_group("seq"))


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its mean over the ranks of the 'data'
    axis: one all-reduce of one flat buffer a dtype, divided by their
    number (each rank's gradient is that of its rows' mean loss, so the
    mean over equal shards is the global batch's), after the sum over
    'seq' (:func:`sum_over_seq`). Nothing to do without a process
    group."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    sum_over_seq(grads)
    mean_over_group(grads, axis_group("data"), axis_size("data"))


_BLOCK_KEY = re.compile(r"^blocks\.(\d+)\.(.*)$")


def _stage_local(name: str) -> bool:
    """Whether a pipelined model's parameter is one stage's (a block's)."""
    return _BLOCK_KEY.match(name) is not None


def gather_stages(named: Dict[str, torch.Tensor], pp) -> Dict[str, torch.Tensor]:
    """Every stage's block entries from this stage's: ``named`` holds
    this stage's ``blocks.<i>.<rest>`` entries (``rest`` may carry a
    suffix, e.g. ``#exp_avg``) and the entries every stage holds alike;
    the result holds every layer's entries and the others as they are.
    The stages hold the same shapes position by position, so the
    tensors of each dtype travel in one all-gather over 'pipe'; a 0-d
    entry (Adam's step count, the same for every parameter) is copied
    from this stage's entry at the same position."""
    pos = {i: p for p, i in enumerate(pp.layers[pp.s])}
    local, out = [], {}
    for k, v in named.items():
        mt = _BLOCK_KEY.match(k)
        if mt is None:
            out[k] = v
        else:
            local.append((pos[int(mt[1])], mt[2], v))
    local.sort(key=lambda e: (e[0], e[1]))
    big = [e for e in local if torch.is_tensor(e[2]) and e[2].dim() > 0]
    for p, rest, v in local:
        if not (torch.is_tensor(v) and v.dim() > 0):
            for r in range(pp.S):
                out[f"blocks.{pp.layers[r][p]}.{rest}"] = v
    for ids in _flat_groups([e[2] for e in big]).values():
        entries = [big[j] for j in ids]
        got = dist.all_gather(torch.cat([e[2].reshape(-1) for e in entries]),
                              axis_group("pipe"))
        for r in range(pp.S):
            off = 0
            for p, rest, v in entries:
                out[f"blocks.{pp.layers[r][p]}.{rest}"] = \
                    got[r, off:off + v.numel()].view_as(v).clone()
                off += v.numel()
    return out


def select_stage(named: Dict[str, torch.Tensor], pp) -> Dict[str, torch.Tensor]:
    """This stage's part of a whole state: its layers' block entries and
    every other entry."""
    mine = set(pp.layers[pp.s])
    return {k: v for k, v in named.items()
            if (mt := _BLOCK_KEY.match(k)) is None or int(mt[1]) in mine}


class Sharding:
    """Where a model's parameters and optimizer state rest on the mesh
    (see the module docstring). ``table``: the layout of every
    parameter name; the model's tensor-parallel leaves must already hold
    this rank's pieces (``tpunet_torch.models.convert``)."""

    def __init__(self, model: torch.nn.Module,
                 table: Dict[str, LeafLayout]):
        self.model = model
        self.table = table
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.group, self.n = axis_group("data"), axis_size("data")
        self.rank = axis_index("data")
        # A pipeline stage's model: its block leaves are its own, the
        # others every stage holds (their gradients summed over 'pipe').
        self.pp = getattr(model, "pp", None)
        self.local = [self.pp is not None and _stage_local(n)
                      for n in self.names]
        # Per parameter: the 'data' split of its moments (None: whole).
        self.split: List[Optional[Shard]] = []
        self.fsdp: List[bool] = []
        self.masters: List[torch.Tensor] = []
        for name, p in zip(self.names, self.params):
            lay = table[name]
            mom = (lay.moments if lay.moments is not None
                   and lay.moments.axis == "data" and self.n > 1 else None)
            self.split.append(mom)
            self.fsdp.append(mom is not None and lay.param == mom)
            if mom is None:
                self.masters.append(p)
            else:
                self.masters.append(torch.nn.Parameter(
                    shard_tensor(p.detach(), mom).contiguous()))
        self._gap_names: List[str] = []
        self._gaps: Optional[torch.Tensor] = None
        self.gathered = True
        self.release()

    @property
    def active(self) -> bool:
        """Whether any parameter or moment is split over 'data'."""
        return any(s is not None for s in self.split)

    def _idx(self, fsdp_only: bool) -> List[int]:
        return [i for i, s in enumerate(self.split) if s is not None
                and (self.fsdp[i] or not fsdp_only)]

    def _all_gather_into(self, idx: List[int], copy: bool) -> None:
        """The whole parameters ``idx`` from their masters: one
        all-gather a dtype; ``copy`` writes into the model's tensors in
        place (ZeRO-1), else they get new storage (FSDP)."""
        for ids in _flat_groups([self.masters[i] for i in idx]).values():
            ids = [idx[j] for j in ids]
            flat = torch.cat([self.masters[i].detach().reshape(-1)
                              for i in ids])
            got = dist.all_gather(flat, self.group)          # [n, total]
            off = 0
            for i in ids:
                m = self.masters[i]
                part = got[:, off:off + m.numel()].reshape(self.n, *m.shape)
                whole = join(part, self.split[i])
                p = self.params[i]
                if copy:
                    p.data.copy_(whole)
                else:
                    p.data = whole.contiguous()
                # New values: the eval-mode caches of derived weights
                # key on the version (a new storage may reuse an address).
                torch.autograd.graph.increment_version(p)
                off += m.numel()

    def gather(self) -> None:
        """FSDP: the whole parameters from the resting pieces, for a
        step or an eval (a no-op when they are whole already)."""
        if self.gathered:
            return
        self._all_gather_into(self._idx(fsdp_only=True), copy=False)
        self.gathered = True

    def release(self) -> None:
        """FSDP: drop the whole parameters (and their gradients); only
        the pieces stay resident."""
        for i in self._idx(fsdp_only=True):
            p = self.params[i]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None
        self.gathered = False

    def _agree_over_model(self) -> None:
        """The leaves replicated over 'model' get the same gradient on
        every rank of the group in exact arithmetic, but some CUDA
        backward kernels (the embedding's) accumulate with atomics in no
        fixed order, and the ranks' copies would drift apart in the
        last bits: their gradients are averaged over the group, one flat
        all-reduce a dtype, so the copies stay equal to the bit. Each leaf's gap to the mean before that, relative to
        the mean's largest entry, is kept as its largest over the steps
        (:meth:`replicated_gaps`): a backward that misses its all-reduce
        over 'model' shows there as a gap of order 1."""
        pairs = [(n, p.grad) for n, p in zip(self.names, self.params)
                 if p.grad is not None and self.model_spec(n) is None]
        if not pairs:
            return
        names = [n for n, _ in pairs]
        gaps = torch.stack(mean_over_group([g for _, g in pairs],
                                           axis_group("model"),
                                           axis_size("model"), gaps=True))
        if names != self._gap_names:
            self._gap_names, self._gaps = names, gaps
        else:
            torch.maximum(self._gaps, gaps, out=self._gaps)

    def replicated_gaps(self) -> Dict[str, float]:
        """Per replicated leaf, the largest gap between this rank's
        gradient and the 'model' group's mean over the steps so far,
        relative to the mean's largest entry (empty without a 'model'
        axis)."""
        if self._gaps is None:
            return {}
        return dict(zip(self._gap_names, self._gaps.tolist()))

    def _sum_over_pipe(self) -> None:
        """The leaves every stage holds: each stage's gradient is its part
        (stage 0's embedding, the last stage's head; none on the others:
        zeros), so they are summed over 'pipe', one flat all-reduce a
        dtype, and every stage then holds the same gradient."""
        idx = [i for i, loc in enumerate(self.local) if not loc]
        for i in idx:
            p = self.params[i]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sum_over_group([self.params[i].grad for i in idx], axis_group("pipe"))

    def reduce_gradients(self) -> None:
        """Every master's gradient := the mean over 'data' of the whole
        parameter's: an all-reduce for the whole masters, a
        reduce-scatter for the pieces (one flat buffer a dtype each); the
        whole gradients of split parameters are then dropped. First, on
        a 'model' axis, the replicated leaves' gradients are made equal
        on its ranks (:meth:`_agree_over_model`); before that, the
        partial gradients of a 'seq' group are summed
        (:func:`sum_over_seq`), and on a 'pipe' axis the stages' parts of
        the leaves they all hold (:meth:`_sum_over_pipe`)."""
        sum_over_seq([p.grad for p in self.params if p.grad is not None])
        if self.pp is not None:
            self._sum_over_pipe()
        if axis_size("model") > 1:
            self._agree_over_model()
        n = self.n
        mean_over_group([p.grad for p, s in zip(self.params, self.split)
                         if s is None and p.grad is not None],
                        self.group, n)
        split = [i for i in self._idx(fsdp_only=False)
                 if self.params[i].grad is not None]
        grads = [self.params[i].grad for i in split]
        for ids in _flat_groups(grads).values():
            sel = [split[j] for j in ids]
            stacked = torch.cat([pieces(self.params[i].grad, self.split[i],
                                        n).reshape(n, -1) for i in sel], 1)
            mine = dist.reduce_scatter(stacked, self.group).div_(n)
            off = 0
            for i in sel:
                m = self.masters[i]
                m.grad = mine[off:off + m.numel()].view_as(m).clone()
                off += m.numel()
                self.params[i].grad = None

    def global_norm(self) -> torch.Tensor:
        """The L2 norm of the whole gradient: each leaf's squares summed
        over the axes it is split over ('data' pieces, tensor- and
        expert-parallel leaves over 'model', a stage's blocks over
        'pipe'), each replicated leaf once. The squares sit in one vector
        by kind of leaf; each axis of more than one rank reduces the
        kinds split over it in one all-reduce (the other kinds are the
        same on its ranks), every rank calling the same collectives."""
        axes = ("data", "model", "pipe")
        kinds = [(d, m, p) for d in (0, 1) for m in (0, 1) for p in (0, 1)]
        parts: Dict[tuple, List[torch.Tensor]] = {k: [] for k in kinds}
        for i, m in enumerate(self.masters):
            if m.grad is None:
                continue
            lay = self.table[self.names[i]]
            parts[(int(self.split[i] is not None),
                   int(lay.param is not None and lay.param.axis == "model"),
                   int(self.local[i]))].append(m.grad)
        dev = self.masters[0].device
        sq = torch.stack([
            torch.stack([n.float() for n in torch._foreach_norm(gs)]
                        ).square().sum() if gs else
            torch.zeros((), dtype=torch.float32, device=dev)
            for gs in parts.values()])
        for a, axis in enumerate(axes):
            if axis_size(axis) == 1:
                continue
            mask = torch.tensor([float(k[a]) for k in kinds], device=dev)
            sq = dist.all_reduce(sq * mask, axis_group(axis)) + sq * (1 - mask)
        return sq.sum().sqrt()

    def after_update(self) -> None:
        """ZeRO-1: the whole parameters from the updated pieces (one
        all-gather a dtype); FSDP: release the whole parameters."""
        zero = [i for i in self._idx(fsdp_only=False) if not self.fsdp[i]]
        if zero:
            self._all_gather_into(zero, copy=True)
        self.release()

    # -- whole state for checkpoints ---------------------------------

    def model_spec(self, name: str) -> Optional[Shard]:
        """The split a parameter's tensor in the model has now: its
        'model' split (the tensor-parallel leaves), None otherwise."""
        lay = self.table.get(name)
        return (lay.param if lay is not None and lay.param is not None
                and lay.param.axis == "model" else None)

    def moment_spec(self, i: int) -> Optional[Shard]:
        """The split of master ``i`` (and its optimizer state)."""
        return self.split[i] or self.model_spec(self.names[i])

    def set_whole(self, name_to_whole: Dict[str, torch.Tensor]) -> None:
        """Cut whole (tensor-parallel-local) parameters into the masters
        and refresh the model's copies: after a load."""
        for i, name in enumerate(self.names):
            if self.split[i] is None or name not in name_to_whole:
                continue
            with torch.no_grad():
                self.masters[i].copy_(shard_tensor(name_to_whole[name],
                                                   self.split[i]))


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the schedule, the global-norm clip (0 =
    off), the number of updates taken (``global_step``, the index of
    the next update), the EMA decay (0 = off) and, on a mesh, the
    :class:`Sharding` (the optimizer then runs on its masters)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    global_step: int = 0
    clip_norm: float = 0.0
    ema_decay: float = 0.0
    sharding: Optional[Sharding] = None

    def __post_init__(self):
        if not 0.0 <= self.ema_decay < 1.0:
            # decay >= 1 freezes the EMA at the init, and eval and the
            # best checkpoint would measure that forever.
            raise ValueError(f"ema_decay must be in [0, 1), got "
                             f"{self.ema_decay}")
        self.reset_ema()

    def ema_sources(self) -> List[torch.Tensor]:
        """What the EMA follows: every parameter (its resting piece under
        FSDP), then every floating buffer (the BN running statistics), in
        module order."""
        params = list(self.model.parameters())
        if self.sharding is not None:
            sh = self.sharding
            params = [m if f else p for m, f, p in
                      zip(sh.masters, sh.fsdp, sh.params)]
        return params + [
            b for b in self.model.buffers() if b.is_floating_point()]

    def reset_ema(self) -> None:
        """The EMA copies := the model's current values (None when off)."""
        self.ema = ([t.detach().clone() for t in self.ema_sources()]
                    if self.ema_decay > 0 else None)

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[None]:
        """Inside, the model holds the EMA copies (parameters and BN
        statistics as a pair, as tpunet evaluates them); the live values
        return on exit. Nothing changes when EMA is off."""
        if self.ema is None:
            yield
            return
        src = self.ema_sources()
        live = [t.data for t in src]
        for t, e in zip(src, self.ema):
            t.data = e
        try:
            yield
        finally:
            for t, d in zip(src, live):
                t.data = d

    @contextlib.contextmanager
    def eval_weights(self) -> Iterator[None]:
        """Inside, the model holds whole weights to evaluate or save:
        the EMA pair when EMA is on, gathered from their pieces under
        FSDP (and dropped again on exit)."""
        with self.ema_weights():
            if self.sharding is None:
                yield
                return
            self.sharding.gather()
            try:
                yield
            finally:
                self.sharding.release()

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        if self.sharding is not None:
            self.model.zero_grad(set_to_none=True)

    def begin_step(self) -> None:
        """Before a step's forward: the whole parameters under FSDP."""
        if self.sharding is not None:
            self.sharding.gather()

    def reduce_gradients(self) -> None:
        """The gradients' mean over the mesh's 'data' axis, on the
        masters."""
        if self.sharding is not None:
            self.sharding.reduce_gradients()
        else:
            reduce_gradients(self.model.parameters())

    def apply_gradients(self) -> None:
        """One optimizer update at the schedule's rate for this step,
        after the clip; then the EMA step (the ``tpunet_optimizer`` and
        ``tpunet_ema`` ranges of a profiled window)."""
        sh = self.sharding
        with span("tpunet_optimizer"):
            if self.clip_norm > 0:
                params = sh.masters if sh is not None else \
                    self.model.parameters()
                clip_by_global_norm([p.grad for p in params
                                     if p.grad is not None], self.clip_norm,
                                    None if sh is None else sh.global_norm())
            lr = self.schedule(self.global_step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.global_step += 1
            if sh is not None:
                sh.after_update()
        if self.ema is not None:
            with torch.no_grad(), span("tpunet_ema"):
                torch._foreach_lerp_(
                    self.ema, [t.detach() for t in self.ema_sources()],
                    1.0 - self.ema_decay)

    # -- whole state (checkpoints): collectives on every rank ----------

    @property
    def pp(self):
        """The model's pipeline plan (None without a 'pipe' axis)."""
        return getattr(self.model, "pp", None)

    def full_model_state(self) -> Dict[str, torch.Tensor]:
        """The model's whole state dict (parameters and buffers), on
        every rank; a pipeline's gathered from every stage."""
        sh = self.sharding
        if sh is None:
            return self.model.state_dict()
        with _gathered(sh):
            sd = self.model.state_dict()
            sd = gather_state_dict(sd, {k: sh.model_spec(k) for k in sd})
        return sd if self.pp is None else gather_stages(sd, self.pp)

    def load_full_model_state(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a whole state dict (another mesh's, or one process's); a
        pipeline stage takes its part."""
        if self.pp is not None:
            sd = select_stage(sd, self.pp)
        sh = self.sharding
        if sh is None:
            load_state_dict(self.model, sd)
            return
        local = shard_state_dict(sd, {k: sh.model_spec(k) for k in sd})
        with _gathered(sh):
            load_state_dict(self.model, local)
            sh.set_whole(local)

    def full_optimizer_state(self) -> dict:
        """The optimizer's state dict with every moment whole, in the
        form of an unsharded run's (a pipeline's indexed by the whole
        model's parameters)."""
        sd = self.optimizer.state_dict()
        sh = self.sharding
        if sh is None:
            return sd
        state = {}
        for i, st in sd["state"].items():
            spec = sh.moment_spec(i)
            state[i] = {k: (gather_tensor(v, spec) if _is_moment(v, sh, i)
                            else v) for k, v in st.items()}
        if self.pp is None:
            return {**sd, "state": state}
        full = gather_stages({f"{sh.names[i]}#{k}": v
                              for i, st in state.items()
                              for k, v in st.items()}, self.pp)
        index = {n: i for i, n in enumerate(self.model.full_param_names)}
        whole: Dict[int, dict] = {}
        for key, v in full.items():
            name, k = key.split("#")
            whole.setdefault(index[name], {})[k] = v
        return {"state": dict(sorted(whole.items())),
                "param_groups": [{**g, "params": list(range(len(index)))}
                                 for g in sd["param_groups"]]}

    def load_full_optimizer_state(self, sd: dict) -> None:
        sh = self.sharding
        if self.pp is not None:
            index = {n: i for i, n in
                     enumerate(self.model.full_param_names)}
            got = {int(i): st for i, st in sd["state"].items()}
            sd = {"state": {j: got[index[n]] for j, n in enumerate(sh.names)
                            if index[n] in got},
                  "param_groups": [{**g, "params": list(range(len(sh.names)))}
                                   for g in sd["param_groups"]]}
        if sh is not None:
            state = {}
            for i, st in sd["state"].items():
                i = int(i)
                spec = sh.moment_spec(i)
                whole = _whole_shape(sh, i)
                state[i] = {k: (shard_tensor(v, spec)
                                if torch.is_tensor(v)
                                and tuple(v.shape) == whole else v)
                            for k, v in st.items()}
            sd = {**sd, "state": state}
        self.optimizer.load_state_dict(sd)

    def full_ema(self) -> Optional[List[torch.Tensor]]:
        """The EMA copies, each whole (None when EMA is off); a
        pipeline's in the whole model's parameter order."""
        if self.ema is None or self.sharding is None:
            return self.ema
        sh = self.sharding
        n = len(sh.params)
        out = [gather_tensor(e, sh.moment_spec(i) if sh.fsdp[i]
                             else sh.model_spec(sh.names[i]))
               if i < n else e for i, e in enumerate(self.ema)]
        if self.pp is None:
            return out
        full = gather_stages(dict(zip(sh.names, out[:n])), self.pp)
        return [full[k] for k in self.model.full_param_names] + out[n:]

    def load_full_ema(self, ema: List[torch.Tensor]) -> None:
        sh = self.sharding
        if self.pp is not None:
            names = self.model.full_param_names
            got = dict(zip(names, ema))
            ema = [got[k] for k in sh.names] + list(ema[len(names):])
        for i, (e, r) in enumerate(zip(self.ema, ema)):
            if sh is not None and i < len(sh.params):
                spec = (sh.moment_spec(i) if sh.fsdp[i]
                        else sh.model_spec(sh.names[i]))
                r = shard_tensor(r.to(e.device), spec)
            e.copy_(r)


@contextlib.contextmanager
def _gathered(sh: Sharding) -> Iterator[None]:
    """The whole parameters inside (FSDP), released after if they were
    not whole before."""
    was = sh.gathered
    sh.gather()
    try:
        yield
    finally:
        if not was:
            sh.release()


def _whole_shape(sh: Sharding, i: int) -> tuple:
    """The shape of parameter ``i``'s moments when gathered whole."""
    m = sh.masters[i]
    spec = sh.moment_spec(i)
    if spec is None or axis_size(spec.axis) == 1:
        return tuple(m.shape)
    shape = list(m.shape)
    shape[spec.dim] *= axis_size(spec.axis)
    return tuple(shape)


def _is_moment(v, sh: Sharding, i: int) -> bool:
    return torch.is_tensor(v) and tuple(v.shape) == tuple(sh.masters[i].shape)
