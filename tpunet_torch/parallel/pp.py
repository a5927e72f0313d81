"""Pipeline parallelism over the mesh's 'pipe' axis, port of
``tpunet/parallel/pp.py``.

tpunet runs one SPMD program: every device holds a stage's slice of the
stacked block parameters, a ``lax.scan`` over ticks computes a stage a
tick and ``lax.ppermute`` hops the activations, and the backward comes
from AD through the scan (``gpipe``) or from a hand-written VJP that
replays the forwards (``onef1b``, ``interleaved``). Here one process
drives one card: a rank of the 'pipe' group holds its stage's blocks as
modules (:class:`PipePlan` says which), and :meth:`PipePlan.run` walks a
schedule table tick by tick. A forward tick runs the stage's blocks on
microbatch m and keeps its autograd graph; a backward tick calls
``torch.autograd.backward`` on that microbatch's stage output with the
gradient the next stage sent (on the last stage, on the microbatch's
loss), and sends its input's gradient back. Stage 0 reads the
microbatches from the batch (its embedding runs inside the tick, so the
embedding's gradient comes with the backward), and the last stage runs
the head and the loss. Each tick ends with one :func:`pipe_hop` over the
group (one ``all_to_all_single``: the tick's activation to the next
stage and gradient to the previous one), which every rank of the group
calls, as tpunet's scan runs one ``ppermute`` a tick; a tick that moves
nothing on any stage skips it on every rank.

The tables are tpunet's, copied as plain functions (the tests hold them
to tpunet's):

- ``gpipe``: the forward ticks of tpunet's scan (stage s runs
  microbatch t - s at tick t), then the same ticks reversed for the
  backward (the transpose of the scan: the last microbatch first);
  every graph lives until its backward, M a stage at the turn;
- ``1f1b``: :func:`onef1b_schedule`, forward of m at stage s on tick
  s + 2m and its backward on tick 2S - 1 - s + 2m; at most min(S, M)
  graphs live a stage (:attr:`PipePlan.max_live` counts them);
- ``interleaved``: v chunks a stage (global stage g = j*S + d holds
  layers g*lc .. (g+1)*lc, :func:`interleaved_layer_order`), run by the
  ops of :func:`interleaved_bwd_schedule` (Megatron's warm-up, one
  forward one backward, cool-down, greedy list-scheduled) with the
  activations on a full ring (chunk j's output from stage S - 1 enters
  chunk j + 1 on stage 0); the forward-only (eval) run uses
  :func:`interleaved_fwd_schedule`.

Deviations from tpunet (ROADMAP Queue C): the graphs are kept instead of
1F1B's replayed forwards (tpunet keeps ``min(S, M)`` stage inputs and
recomputes; here the same count of graphs is live, each with its
activations); a bubble tick idles instead of computing on zeros and
throwing the result away; the interleaved training run takes its
forwards from the backward table, since nothing is replayed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpunet_torch.parallel.dist import pipe_hop

SCHEDULES = ("gpipe", "1f1b", "interleaved")

Op = Optional[Tuple[str, int, int]]     # ("F" | "B", microbatch, chunk)


# -- tpunet's schedule tables ----------------------------------------------

def onef1b_schedule(n_stages: int, n_micro: int) -> list:
    """The 1F1B tick table: ``table[t][s]`` is ``("F", m)``, ``("B", m)``,
    or ``None`` (idle). Forward of microbatch m runs at stage s on tick
    ``s + 2m``; backward on tick ``2S - 1 - s + 2m``. F-ticks at stage s
    all share parity ``s % 2`` and B-ticks parity ``(s+1) % 2``, so the
    two streams interleave without collision; the last stage runs
    ``F(m), B(m), F(m+1), B(m+1), ...``. Total ticks ``2(M + S - 1)``,
    the same bubble fraction as GPipe (non-interleaved 1F1B improves
    memory, not bubble)."""
    S, M = n_stages, n_micro
    total = 2 * (M + S - 1)
    table = [[None] * S for _ in range(total)]
    for s in range(S):
        for m in range(M):
            table[s + 2 * m][s] = ("F", m)
            table[2 * S - 1 - s + 2 * m][s] = ("B", m)
    return table


def interleaved_layer_order(L: int, S: int, v: int) -> list:
    """``order[storage_idx] = semantic layer`` for the chunk-permuted
    stacking: device d's contiguous slice holds chunks d, S+d, 2S+d, ...
    (global stage g = j*S + d), so storage position d*(v*lc) + j*lc + o
    carries semantic layer (j*S + d)*lc + o."""
    if L % (S * v):
        raise ValueError(f"{L} layers not divisible by {S} stages x "
                         f"{v} virtual chunks")
    lc = L // (S * v)
    order = []
    for d in range(S):
        for j in range(v):
            g = j * S + d
            order.extend(range(g * lc, (g + 1) * lc))
    return order


def interleaved_fwd_schedule(S: int, M: int, v: int) -> list:
    """The closed-form dense forward table: ``table[t][d]`` is
    ``("F", m, j)`` or None. Device d runs its k-th chunk-op at tick
    d + k with k enumerating (microbatch-group, chunk, in-group
    microbatch): k = (m // S)*S*v + j*S + (m % S). Every hop (d -> d+1,
    and the (S-1) -> 0 wrap into the next chunk) lands with slack exactly
    1, so the forward finishes in vM + S - 1 ticks."""
    if M % S:
        raise ValueError(f"interleaved needs microbatches ({M}) "
                         f"divisible by stages ({S})")
    n = v * M
    table = [[None] * S for _ in range(n + S - 1)]
    for d in range(S):
        for k in range(n):
            r, kk = divmod(k, S * v)
            j, i = divmod(kk, S)
            table[d + k][d] = ("F", r * S + i, j)
    return table


def _interleaved_oplist(S: int, M: int, v: int, d: int) -> list:
    """Device d's op order (Megatron interleaved 1F1B): W(d) warmup
    chunk-forwards, then one-F-one-B, then B cooldown. F-stream order
    matches the forward schedule; the B stream is the same enumeration
    with chunks reversed (deepest chunk first)."""
    def fop(k):
        r, kk = divmod(k, S * v)
        j, i = divmod(kk, S)
        return ("F", r * S + i, j)

    def bop(b):
        r, bb = divmod(b, S * v)
        j, i = divmod(bb, S)
        return ("B", r * S + i, v - 1 - j)

    n = v * M
    W = min(n, 2 * (S - 1 - d) + (v - 1) * S)
    ops = [fop(k) for k in range(W)]
    f, b = W, 0
    while f < n:
        ops.append(fop(f)); f += 1     # noqa: E702
        ops.append(bop(b)); b += 1     # noqa: E702
    while b < n:
        ops.append(bop(b)); b += 1     # noqa: E702
    return ops


def _alloc_intervals(intervals):
    """Greedy interval-graph slot allocation: ``intervals`` is a list of
    (start, end, key) with inclusive occupancy [start, end]; returns
    ({key: slot}, n_slots)."""
    slots = {}
    free = []
    busy = []   # (end, slot) active
    n = 0
    for start, end, key in sorted(intervals):
        still = []
        for e, sl in busy:
            if e < start:
                free.append(sl)
            else:
                still.append((e, sl))
        busy = still
        if free:
            sl = free.pop()
        else:
            sl = n
            n += 1
        busy.append((end, sl))
        slots[key] = sl
    return slots, max(n, 1)


def _interleaved_rows(S: int, M: int, v: int):
    """Greedy list scheduling of the combined forward/backward table:
    its rows (``row[d]`` is ``("F" | "B", m, j)`` or None) and the tick
    each (device, m, j) forward and backward ran. Dependencies (producer
    tick + 1 <= consumer tick, F-before-its-B) are enforced during
    construction."""
    if M % S:
        raise ValueError(f"interleaved needs microbatches ({M}) "
                         f"divisible by stages ({S})")
    ops = [_interleaved_oplist(S, M, v, d) for d in range(S)]
    for d in range(S):   # F(m, j) precedes B(m, j) on every device
        pos = {op: i for i, op in enumerate(ops[d])}
        for (kind, m, j), i in pos.items():
            if kind == "B":
                assert pos[("F", m, j)] < i, (d, m, j)
    ptr = [0] * S
    done_f, done_b = {}, {}
    rows = []
    t = 0
    while any(p < len(o) for p, o in zip(ptr, ops)):
        row = [None] * S
        for d in range(S):
            if ptr[d] >= len(ops[d]):
                continue
            kind, m, j = ops[d][ptr[d]]
            if kind == "F":
                if d > 0:
                    ready = done_f.get((d - 1, m, j))
                elif j > 0:
                    ready = done_f.get((S - 1, m, j - 1))
                else:
                    ready = -1
            else:
                own = done_f.get((d, m, j))
                if d < S - 1:
                    up = done_b.get((d + 1, m, j))
                elif j < v - 1:
                    up = done_b.get((0, m, j + 1))
                else:
                    up = -1
                ready = (None if own is None or up is None
                         else max(own, up))
            if ready is not None and t >= ready + 1:
                row[d] = (kind, m, j)
        if all(r is None for r in row):
            raise RuntimeError(
                f"interleaved schedule deadlock at tick {t} "
                f"(S={S}, M={M}, v={v})")
        for d in range(S):
            if row[d] is not None:
                kind, m, j = row[d]
                (done_f if kind == "F" else done_b)[(d, m, j)] = t
                ptr[d] += 1
        rows.append(row)
        t += 1
    return rows, done_f, done_b


def interleaved_bwd_schedule(S: int, M: int, v: int) -> dict:
    """:func:`_interleaved_rows` plus tpunet's buffer allocation (the
    slots its scan reads and writes; the port's executor reads only
    ``kind``/``m``/``j``, through :func:`interleaved_ops`). Returns numpy
    tables [T, S]:

    - kind (0 idle / 1 F / 2 B), m, j;
    - rs_save / rs_read: residual slot an F-tick saves its chunk input
      into / a B-tick reads from (-1 none);
    - af_save / ab_save: arrival slot to store this tick's delivery
      into (-1 discard);
    - af_read / ab_read: arrival slot an F/B-tick reads its input
      activation/cotangent from (-1 = boundary: the batch / the loss);

    and scalars n_resid / n_arr_f / n_arr_b / n_ticks."""
    rows, done_f, done_b = _interleaved_rows(S, M, v)
    T = len(rows)

    kind = np.zeros((T, S), np.int32)
    mi = np.zeros((T, S), np.int32)
    ji = np.zeros((T, S), np.int32)
    rs_save = -np.ones((T, S), np.int32)
    rs_read = -np.ones((T, S), np.int32)
    af_save = -np.ones((T, S), np.int32)
    af_read = -np.ones((T, S), np.int32)
    ab_save = -np.ones((T, S), np.int32)
    ab_read = -np.ones((T, S), np.int32)
    for t, row in enumerate(rows):
        for d, op in enumerate(row):
            if op is None:
                continue
            kind[t, d] = 1 if op[0] == "F" else 2
            mi[t, d] = op[1]
            ji[t, d] = op[2]

    n_res = n_af = n_ab = 1
    for d in range(S):
        iv = [(done_f[(d, m, j)], done_b[(d, m, j)], (m, j))
              for m in range(M) for j in range(v)]
        sl, nr = _alloc_intervals(iv)
        n_res = max(n_res, nr)
        for (m, j), s_ in sl.items():
            rs_save[done_f[(d, m, j)], d] = s_
            rs_read[done_b[(d, m, j)], d] = s_
        iv = []
        for m in range(M):
            for j in range(v):
                if d > 0:
                    tp = done_f[(d - 1, m, j)]
                elif j > 0:
                    tp = done_f[(S - 1, m, j - 1)]
                else:
                    continue
                iv.append((tp + 1, done_f[(d, m, j)], (m, j)))
        if iv:
            sl, na = _alloc_intervals(iv)
            n_af = max(n_af, na)
            for (m, j), s_ in sl.items():
                iv_start = [x for x in iv if x[2] == (m, j)][0][0]
                af_save[iv_start, d] = s_
                af_read[done_f[(d, m, j)], d] = s_
        iv = []
        for m in range(M):
            for j in range(v):
                if d < S - 1:
                    tp = done_b[(d + 1, m, j)]
                elif j < v - 1:
                    tp = done_b[(0, m, j + 1)]
                else:
                    continue
                iv.append((tp + 1, done_b[(d, m, j)], (m, j)))
        if iv:
            sl, nb = _alloc_intervals(iv)
            n_ab = max(n_ab, nb)
            for (m, j), s_ in sl.items():
                iv_start = [x for x in iv if x[2] == (m, j)][0][0]
                ab_save[iv_start, d] = s_
                ab_read[done_b[(d, m, j)], d] = s_
    return dict(kind=kind, m=mi, j=ji, rs_save=rs_save, rs_read=rs_read,
                af_save=af_save, af_read=af_read, ab_save=ab_save,
                ab_read=ab_read, n_resid=n_res, n_arr_f=n_af,
                n_arr_b=n_ab, n_ticks=T)


# -- the port's op tables ----------------------------------------------------

def gpipe_schedule(n_stages: int, n_micro: int, backward: bool = True
                   ) -> List[List[Op]]:
    """GPipe as ops: tpunet's scan, stage s forward of microbatch t - s
    at tick t (M + S - 1 ticks), then (``backward``) its transpose, the
    same ticks reversed: at backward tick t', stage s runs the backward
    of microbatch (M + S - 2 - t') - s."""
    S, M = n_stages, n_micro
    T = M + S - 1
    rows = [[("F", t - s, 0) if 0 <= t - s < M else None for s in range(S)]
            for t in range(T)]
    if backward:
        rows += [[("B", T - 1 - t - s, 0) if 0 <= T - 1 - t - s < M
                  else None for s in range(S)] for t in range(T)]
    return rows


def onef1b_ops(n_stages: int, n_micro: int) -> List[List[Op]]:
    """:func:`onef1b_schedule` as ops (chunk 0)."""
    return [[None if op is None else (op[0], op[1], 0) for op in row]
            for row in onef1b_schedule(n_stages, n_micro)]


def interleaved_ops(n_stages: int, n_micro: int, v: int,
                    backward: bool = True) -> List[List[Op]]:
    """The interleaved schedule as ops: the rows of
    :func:`interleaved_bwd_schedule`'s table (every chunk forward and
    backward, :func:`_interleaved_rows`), or without ``backward``
    :func:`interleaved_fwd_schedule`'s."""
    if not backward:
        return interleaved_fwd_schedule(n_stages, n_micro, v)
    return _interleaved_rows(n_stages, n_micro, v)[0]


def stage_layers(n_layers: int, n_stages: int, stage: int,
                 virtual: int = 1) -> List[int]:
    """The layers stage ``stage`` holds, chunk by chunk: chunk j is
    global stage g = j*S + stage, layers g*lc .. (g+1)*lc - 1 with lc =
    L / (S * virtual) (one chunk of L / S layers at ``virtual`` 1)."""
    S, v = n_stages, virtual
    if n_layers % (S * v):
        raise ValueError(f"{n_layers} layers not divisible by {S} stages "
                         f"x {v} virtual chunks")
    lc = n_layers // (S * v)
    out = []
    for j in range(v):
        g = j * S + stage
        out.extend(range(g * lc, (g + 1) * lc))
    return out


class StageWork:
    """What a stage computes, for :meth:`PipePlan.run`:
    ``first(m)`` stage 0's input of microbatch m (the embedding, under
    autograd in training); ``chunk(j, x, m)`` chunk j's blocks on x,
    returning (y, extra): ``extra`` a scalar added to the microbatch's
    backward (the chunk's weighted MoE load-balance terms) or None;
    ``last(m, y)`` the last chunk's output through the head: the
    microbatch's loss in training, its output otherwise."""

    def first(self, m: int) -> torch.Tensor:
        raise NotImplementedError

    def chunk(self, j: int, x: torch.Tensor, m: int):
        raise NotImplementedError

    def last(self, m: int, y: torch.Tensor):
        raise NotImplementedError


class PipePlan:
    """One rank's view of a pipeline: ``n_stages`` stages over ``group``
    (the mesh's 'pipe' group; this rank is stage ``stage``), ``n_micro``
    microbatches a step under ``schedule``, ``virtual`` chunks a stage
    when interleaved (else 1); ``layers[r]`` the layers stage r holds and
    ``chunks[j]`` this stage's chunk j. ``stats`` holds the last
    training run's ticks, busy ticks, hops, their host seconds and the
    most graphs it kept at once (``live``); ``max_live`` that most over
    every training run so far."""

    def __init__(self, n_layers: int, n_stages: int, stage: int,
                 n_micro: int, schedule: str = "gpipe", virtual: int = 2,
                 group=None):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pp_schedule {schedule!r}; "
                             "expected gpipe|1f1b|interleaved")
        self.S, self.s, self.M = n_stages, stage, n_micro
        self.schedule = schedule
        self.v = virtual if schedule == "interleaved" else 1
        self.group = group
        self.n_layers = n_layers
        self.layers = [stage_layers(n_layers, n_stages, r, self.v)
                       for r in range(n_stages)]
        lc = n_layers // (n_stages * self.v)
        mine = self.layers[stage]
        self.chunks = [mine[j * lc:(j + 1) * lc] for j in range(self.v)]
        self.stats: Dict[str, float] = {}
        self.max_live = 0
        self._tables: Dict[bool, List[List[Op]]] = {}

    def table(self, train: bool) -> List[List[Op]]:
        """The op table of a training run (forwards and backwards) or of
        a forward-only run."""
        if train not in self._tables:
            S, M = self.S, self.M
            if self.schedule == "interleaved":
                t = interleaved_ops(S, M, self.v, backward=train)
            elif self.schedule == "1f1b" and train:
                t = onef1b_ops(S, M)
            else:
                t = gpipe_schedule(S, M, backward=train)
            self._tables[train] = t
        return self._tables[train]

    # The neighbours of chunk j of stage s: where its output goes (F) and
    # where its input's gradient goes (B); None at the pipeline's ends.
    def next_of(self, s: int, j: int) -> Optional[Tuple[int, int]]:
        if s < self.S - 1:
            return s + 1, j
        return (0, j + 1) if j < self.v - 1 else None

    def prev_of(self, s: int, j: int) -> Optional[Tuple[int, int]]:
        if s > 0:
            return s - 1, j
        return (self.S - 1, j - 1) if j > 0 else None

    def run(self, work: StageWork, train: bool, act_shape: Sequence[int],
            dtype: torch.dtype, device) -> Dict[int, object]:
        """Walk the schedule: ``work``'s forwards (and with ``train`` the
        backwards, into the parameters' ``.grad``) of this stage, one
        :func:`pipe_hop` a tick that moves anything. Every activation and
        gradient that hops is ``act_shape`` in ``dtype``. Returns the last
        stage's ``work.last`` results by microbatch (empty elsewhere)."""
        s, S = self.s, self.S
        table = self.table(train)
        live: Dict[Tuple[int, int], tuple] = {}
        arr_f: Dict[Tuple[int, int], torch.Tensor] = {}
        arr_b: Dict[Tuple[int, int], torch.Tensor] = {}
        out: Dict[int, object] = {}
        hops = busy = peak = 0
        hop_s = 0.0
        for row in table:
            op = row[s]
            send = None
            if op is not None:
                busy += 1
                kind, m, j = op
                if kind == "F":
                    with torch.set_grad_enabled(train):
                        if s == 0 and j == 0:
                            x, leaf = work.first(m), None
                        else:
                            x = arr_f.pop((m, j))
                            if train:
                                x = leaf = x.detach().requires_grad_()
                            else:
                                leaf = None
                        y, extra = work.chunk(j, x, m)
                        nxt = self.next_of(s, j)
                        if nxt is None:
                            y = work.last(m, y)
                            if extra is not None:
                                y = y + extra
                                extra = None
                            out[m] = y.detach() if train else y
                        else:
                            send = (nxt[0], y.detach())
                    if train:
                        live[(m, j)] = (leaf, y, extra)
                        peak = max(peak, len(live))
                else:
                    leaf, y, extra = live.pop((m, j))
                    tensors, grads = [y], [None]
                    if self.next_of(s, j) is not None:
                        grads = [arr_b.pop((m, j))]
                    if extra is not None:
                        tensors.append(extra)
                        grads.append(None)
                    torch.autograd.backward(tensors, grads)
                    prv = self.prev_of(s, j)
                    if prv is not None:
                        send = (prv[0], leaf.grad)
            # What the neighbours send this rank this tick, from the table.
            recv = {}
            moved = False
            for r, rop in enumerate(row):
                if rop is None:
                    continue
                rk, rm, rj = rop
                dst = (self.next_of(r, rj) if rk == "F"
                       else self.prev_of(r, rj))
                if dst is None:
                    continue
                moved = True
                if dst[0] == s:
                    recv[r] = (rk, rm, dst[1])
            if not moved:
                continue
            t0 = time.perf_counter()
            got = pipe_hop(send, sorted(recv), act_shape, dtype, device,
                           self.group)
            hop_s += time.perf_counter() - t0
            hops += 1
            for r, (rk, rm, rj) in recv.items():
                (arr_f if rk == "F" else arr_b)[(rm, rj)] = got[r]
        if live or arr_f or arr_b:
            raise RuntimeError(f"pipeline stage {s}: {len(live)} graphs, "
                               f"{len(arr_f) + len(arr_b)} arrivals left "
                               "after the schedule")
        if train:
            self.max_live = max(self.max_live, peak)
            self.stats = dict(ticks=len(table), busy_ticks=busy, hops=hops,
                              hop_s=hop_s, live=peak)
        return out


def split_micro(t: Optional[torch.Tensor], n_micro: int
                ) -> List[Optional[torch.Tensor]]:
    """``t``'s rows cut into ``n_micro`` contiguous microbatches (tpunet's
    ``reshape(n_micro, mb, ...)``); None stays None."""
    if t is None:
        return [None] * n_micro
    if t.shape[0] % n_micro:
        raise ValueError(f"local batch {t.shape[0]} not divisible by "
                         f"{n_micro} microbatches")
    return list(t.split(t.shape[0] // n_micro))


def micro_seed(base: int, m: int, g: int) -> int:
    """The dropout seed of microbatch ``m`` on global stage ``g``, from
    the step's ``base`` draw: tpunet folds its key per (tick, stage,
    layer), the port seeds one generator per (microbatch, stage)."""
    words = np.random.SeedSequence([base, m, g]).generate_state(2, np.uint32)
    return (int(words[0]) << 32 | int(words[1])) & (2**63 - 1)

