"""Epoch-driven training loop with best-checkpoint tracking, port of
``tpunet/train/loop.py``.

The reference's shape: per epoch, a reshuffled train pass, a full eval
pass, the scheduler tick, one epoch line, best-accuracy tracking; then
the summary lines. Here the step is the port's train step on one device
(``cuda`` unless the caller asks for ``cpu``), the metrics are exact
sums read once per epoch, the best weights are a ``.pth`` in the port's
layout and the full state allows ``--resume``; all of it for any model
of ``ModelConfig``, with or without BN. The LM (``lm``) trains on token
rows with its own steps (next-token prediction, packed documents when
``pack_docs``), and its metric unit is the token: its accuracy is
next-token accuracy, and its epoch record carries ``tokens_per_sec``
where the image models' carries ``examples_per_sec``. Each epoch
appends one plain record to ``<checkpoint-dir>/metrics.jsonl``
(``docs/metrics_schema.md``).

Under a process group (``tpunet_torch.parallel``) the Trainer is one
rank of a data-parallel run (tpunet's ``_epoch_batches`` and
``evaluate``): its device is the rank's card (``local_device``), it
trains on its slice of every global batch and evaluates its slice of
every padded global eval batch, and the metric sums are summed over the
ranks when an epoch or an eval ends, so every rank holds the global
numbers and the best checkpoint follows the global test accuracy (the
reference script's is rank 0's own, :196,224). Rank 0 alone writes
files, and the other ranks wait for its commits before they exit.

On a mesh (``MeshConfig``: ``--mesh-data``, ``--mesh-model``,
``--zero1``, ``--fsdp``) the Trainer builds the mesh's groups, cuts the
model's tensor-parallel leaves for its 'model' rank, and lays the state
out as ``tpunet_torch.parallel.tp.layout`` says (``TrainState.sharding``).
The batch is split over the 'data' axis only: the ranks of a 'model'
group read the same rows, and so do the ranks of a 'seq' group
(sequence parallelism, ``--mesh-seq`` with ``--attention ring`` or
``ulysses``), each computing its share of the positions, in training
and in eval alike. Eval runs on whole (gathered) FSDP weights,
and checkpoints hold the whole state, so ``--resume`` may take another
mesh. The LM's CE is vocab-parallel when ``vocab_ce`` resolves to
``sharded``. With ``--mesh-pipe`` the pipelined models (``vit_pp``,
``lm_pp``) keep their stage's blocks on each rank of a 'pipe' group,
whose ranks read the same rows; the step runs the pipeline schedule
(``tpunet_torch.train.steps.fit_lm_batch``), and the checkpoints
hold the whole model in plain layer order with tpunet's pipeline
metadata beside it (``state.pt``'s entries, ``best_meta.json``).

Observability (``tpunet_torch.obs``) is threaded through as tpunet's
Trainer does it: per-step host laps, the data-wait split, the profile
window, the watchdog, and one ``obs_epoch`` record an epoch (MFU, CUDA
memory, heartbeat) after the plain record, in the same
``metrics.jsonl``; every record carries the run identity and the
config fingerprint. The default path issues no device sync of its own:
``torch.cuda.synchronize`` runs only at a profile window's two edges.

The host loader is tpunet's native C++ prefetcher
(``tpunet_torch/data/native.py``) over the same index order when
``native_loader`` is set and it can be built (never for ``eval_only``
or packed documents), numpy otherwise. With ``ema_decay`` > 0 eval and
``best.pth`` read the EMA parameters and BN statistics.

Preemption (tpunet's ``PreemptionGuard``): SIGTERM sets a flag that the
loop reads at step boundaries. Under a process group the ranks agree on
it through the store (``agree_any``) every ``STOP_POLL_STEPS`` steps
and once after each epoch, so every rank stops at the same step. A
stopped epoch writes a ``partial: true`` record without eval fields and
saves the state marked partial, so ``--resume`` re-runs that epoch while
the step counter goes on; a second SIGTERM abandons the save and exits
at once. ``--halt-on-unhealthy`` above one process routes a fatal alert
through the same stop, and the run then raises ``RunUnhealthyError``.

Checkpoints are written behind the loop (``tpunet_torch.ckpt``): a save
costs the step loop its snapshot's dispatch, and the run waits for them
once, at its end (bounded by what remains of a preemption's grace
window).

Faults and elasticity (tpunet's, ``tpunet_torch/elastic/``): ``--chaos``
arms the process-global injector, whose ``step`` hook runs at the top
of every step inside the timed window and whose IO hooks the
checkpointer runs. Under ``python -m tpunet_torch.elastic`` the Trainer
reads the agent's generation (``TPUNET_ELASTIC_*``), the previous
incarnation's mesh (rank 0 writes this one's), sets the
``elastic_generation`` and ``elastic_world_processes`` gauges, emits a
``recovered`` record when a later generation has restored, and writes
the ``done`` marker once every epoch completed. With
``--evict-on-straggler`` a straggler-shaped watchdog alert on this rank
claims the evict marker and requests the agreed stop: every rank saves
at the same step, and the agents re-mesh without the claimer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tpunet_torch.ckpt import Checkpointer
from tpunet_torch.config import TrainConfig
from tpunet_torch.data import (eval_batches, get_dataset,
                               host_index_sequence, steps_per_epoch,
                               timed_batches, train_batches)
from tpunet_torch.elastic import events as elastic_events
from tpunet_torch.models import create_model, num_params
from tpunet_torch.models.convert import (load_state_dict, shard_model,
                                         state_dict_file)
from tpunet_torch.obs import JsonlSink, Observability, RunUnhealthyError
from tpunet_torch.obs import flightrec
from tpunet_torch.obs.history import train_fingerprint
from tpunet_torch.obs.identity import ensure_run_id
from tpunet_torch.obs.perf import train_flops_per_unit
from tpunet_torch.ops.vocab_ce import resolve_vocab_ce
from tpunet_torch.parallel.dist import (agree_any, is_initialized,
                                        local_device, process_count,
                                        process_index, sync_hosts)
from tpunet_torch.parallel.mesh import (axis_index, axis_size, make_mesh,
                                        mesh_shape_dict, set_mesh)
from tpunet_torch.parallel.tp import layout
from tpunet_torch.train import metrics as M
from tpunet_torch.train.state import (Sharding, TrainState, lr_schedule,
                                      make_optimizer, select_stage)
from tpunet_torch.train.steps import (make_eval_step, make_lm_eval_step,
                                      make_lm_train_step, make_train_step)
from tpunet_torch.utils.logging import (MetricsLogger, epoch_line, log0,
                                        summary_lines)
from tpunet_torch.utils.preemption import PreemptionGuard
from tpunet_torch.utils.prng import step_generator
from tpunet_torch.utils.timing import Timer


def _shared_run_id(directory: str, resume: bool) -> str:
    """The run's id (docs/metrics_schema.md, "Run identity"), the same on
    every rank: rank 0 creates or reuses (``--resume``) the id persisted
    under the checkpoint directory, and after a barrier the other ranks
    read it."""
    rid = ensure_run_id(directory, resume) if process_index() == 0 else ""
    sync_hosts("run-id")
    return rid or ensure_run_id(directory, resume=True, persist=False)


class Trainer:
    """Owns the model, the optimizer, the steps, and the epoch loop."""

    def __init__(self, cfg: TrainConfig, dataset=None, device: str = "cuda"):
        if cfg.log_every_steps < 0:
            raise ValueError(f"log_every_steps must be >= 0, got "
                             f"{cfg.log_every_steps}")
        if not 0.0 <= cfg.optim.warmup_epochs < cfg.epochs:
            raise ValueError(
                f"warmup_epochs ({cfg.optim.warmup_epochs}) must be in "
                f"[0, epochs={cfg.epochs})")
        self.cfg = cfg
        if cfg.data.mixup_alpha < 0 or cfg.data.cutmix_alpha < 0:
            raise ValueError("mixup/cutmix alphas must be >= 0")
        if cfg.is_lm and (cfg.data.mixup_alpha > 0
                          or cfg.data.cutmix_alpha > 0):
            raise ValueError("mixup/cutmix are image-family options; "
                             "the LM train step does not read them")
        self.device = (local_device(torch.device(device).type)
                       if is_initialized() else torch.device(device))
        self.rank, self.ranks = process_index(), process_count()
        self.mesh = make_mesh(cfg.mesh)
        # The batch is split over the 'data' axis alone.
        self.data_rank, self.data_ranks = axis_index("data"), \
            axis_size("data")
        ds = dataset if dataset is not None else get_dataset(cfg.data)
        self.train_x, self.train_y, self.test_x, self.test_y = ds
        self.spe = steps_per_epoch(len(self.train_x), cfg.data.batch_size)
        if self.spe == 0:
            raise ValueError("batch size larger than training set")
        accum = cfg.optim.grad_accum
        if (cfg.is_pipelined and accum > 1
                and axis_size("pipe") > 1):
            # Time-microbatching (accum) wraps stage-microbatching: each
            # accum slice must still split into pp_microbatches per data
            # shard (tpunet/train/loop.py:137-149).
            npipe_mb = cfg.model.pp_microbatches
            per_shard = cfg.data.batch_size // accum // self.data_ranks
            if per_shard % npipe_mb:
                raise ValueError(
                    f"grad_accum x pipeline: per-data-shard microbatch "
                    f"{per_shard} (batch {cfg.data.batch_size} / accum "
                    f"{accum} / data {self.data_ranks}) is not divisible "
                    f"by pp_microbatches {npipe_mb}")
        model = create_model(cfg.model, device=str(self.device),
                             generator=torch.Generator().manual_seed(cfg.seed),
                             image_size=cfg.data.image_size)
        if cfg.model.pretrained_path:
            sd = state_dict_file(cfg.model.pretrained_path)
            if getattr(model, "pp", None) is not None:
                sd = select_stage(sd, model.pp)     # this stage's blocks
            load_state_dict(model, sd)
        self.n_params = num_params(model)
        sharding = None
        if self.mesh.size > 1 and (cfg.mesh.zero1 or cfg.mesh.fsdp
                                   or axis_size("model") > 1
                                   or getattr(model, "pp", None)):
            table = layout({k: tuple(p.shape) for k, p
                            in model.named_parameters()}, cfg.model,
                           self.mesh.shape, zero1=cfg.mesh.zero1,
                           fsdp=cfg.mesh.fsdp)
            shard_model(model, table, cfg.model)
            sharding = Sharding(model, table)
        self._schedule = lr_schedule(cfg.optim, self.spe, cfg.epochs)
        self.state = TrainState(
            model, make_optimizer(model.parameters() if sharding is None
                                  else sharding.masters, cfg.optim),
            self._schedule, clip_norm=cfg.optim.clip_norm,
            ema_decay=cfg.optim.ema_decay, sharding=sharding)
        # The LM's 'seq' ranks count their own positions; the ViT's hold
        # the whole logits after the pool, which count once.
        self._metric_axes = ("data", "seq") if cfg.is_lm else ("data",)
        if cfg.is_lm:
            sharded_ce = resolve_vocab_ce(cfg.model.vocab_ce,
                                          axis_size("model"),
                                          cfg.model.vocab_size) == "sharded"
            self.train_step = make_lm_train_step(
                cfg.optim, cfg.data.pack_docs, sharded_ce,
                cfg.model.moe_aux_weight)
            self.eval_step = make_lm_eval_step(cfg.data.pack_docs,
                                               sharded_ce)
            # Token rows and segment ids go to the device as int32; the
            # image labels as int64 (cross_entropy's class index type).
            self._label_dtype = None
        else:
            self.train_step = make_train_step(cfg.data, cfg.optim,
                                              cfg.model.moe_aux_weight)
            self.eval_step = make_eval_step(cfg.data)
            self._label_dtype = torch.int64
        # Observability (tpunet_torch/obs/): per-step timing + stall
        # split + windowed profiling. Constructed before the
        # Checkpointer so checkpoint saves report into the same
        # registry.
        obs_cfg = cfg.obs
        if obs_cfg.enabled and not obs_cfg.run_id:
            obs_cfg = dataclasses.replace(obs_cfg, run_id=_shared_run_id(
                cfg.checkpoint.directory, cfg.checkpoint.resume))
        self.obs = Observability(
            obs_cfg, profile_dir=cfg.profile_dir,
            checkpoint_dir=cfg.checkpoint.directory,
            unit="tokens" if cfg.is_lm else "examples",
            # resume keeps the persisted run_id, so the restored
            # stream continues the same fleet identity.
            resume=cfg.checkpoint.resume, device=self.device)
        if self.obs.enabled:
            # Config fingerprint joins runs of the same workload (the
            # run-history store and cross-run compare judge run N
            # against run N-1 only when the fingerprints match).
            ident = self.obs.registry.identity()
            self.obs.registry.set_identity(
                **ident, config_fingerprint=train_fingerprint(cfg))
        self.obs.set_flops_per_unit(train_flops_per_unit(
            cfg.model, cfg.data, n_params=self.n_params))
        self.ckpt = Checkpointer(cfg.checkpoint, obs=self.obs)
        self._prefetcher = None
        if (cfg.data.native_loader and not cfg.eval_only
                and not cfg.data.pack_docs):
            # The native gather moves raw bytes a row, so uint8 image
            # rows and int32 token rows share the path; packed documents
            # carry [B, T] segment ids in the label slot, which the
            # prefetcher's scalar-label ABI does not cover (numpy there).
            from tpunet_torch.data import native
            if native.available():
                self._prefetcher = native.NativePrefetcher(
                    self.train_x, self.train_y.astype(np.int32),
                    cfg.data.batch_size // self.data_ranks)
        self.guard = PreemptionGuard(deadline_s=cfg.preempt_grace_s)
        # Fault injection (--chaos): armed process-globally so the
        # checkpointer's IO hooks reach the same injector; scoped to this
        # rank (host=H events address one gang member).
        self._chaos = None
        if cfg.chaos:
            from tpunet_torch.elastic import chaos as chaos_mod
            self._chaos = chaos_mod.install(cfg.chaos,
                                            process_index=self.rank)
        # Elastic-agent context (TPUNET_ELASTIC_* env): generation gauges,
        # the previous incarnation's mesh for the "recovered" record, and
        # this incarnation's mesh persisted for the next one.
        self._elastic = elastic_events.agent_env()
        self._prev_mesh = None
        if self._elastic is not None:
            run_dir = cfg.checkpoint.directory
            self._prev_mesh = elastic_events.read_mesh(run_dir)
            if self.rank == 0:
                elastic_events.write_mesh(run_dir, mesh_shape_dict(self.mesh))
            if self.obs.enabled:
                reg = self.obs.registry
                reg.gauge("elastic_generation").set(
                    self._elastic["generation"])
                reg.gauge("elastic_world_processes").set(self.ranks)
        self._watchdog_halt = None
        # Proactive checkpoint-and-evict (--evict-on-straggler): a
        # straggler-shaped alert on THIS rank claims the evict marker
        # (first claim wins: every rank's lap slows in lockstep data
        # parallelism) and requests the agreed stop, so every rank
        # checkpoints together and the agents re-mesh without the claimer.
        self._evict_requested = None
        if self.obs.watchdog is not None and cfg.obs.evict_on_straggler:
            def _evict(record):
                if self._evict_requested is None:
                    claimed = elastic_events.write_evict_marker(
                        cfg.checkpoint.directory, process_index=self.rank,
                        host=elastic_events.agent_host(),
                        reason=str(record.get("reason", "straggler")),
                        detail=record)
                    print(f"[process {self.rank}] EVICT "
                          f"{'claimed' if claimed else 'joined'} after "
                          f"watchdog alert: {record}", flush=True)
                    self._evict_requested = record
                    self.guard.request()
            self.obs.watchdog.on_evict = _evict
        if self.ranks > 1 and self.obs.watchdog is not None:
            # --halt-on-unhealthy across processes: a fatal alert on one
            # rank must not raise there (the others would wait in their
            # next collective). It requests the agreed stop instead, and
            # train() raises once every rank has stopped at the same step
            # with the partial state saved, so the exit code still says
            # "unhealthy" (2), not "preempted" (0).
            def _halt(record):
                print(f"[process {self.rank}] HALT requested by watchdog: "
                      f"{record}", flush=True)
                self._watchdog_halt = record
                self.guard.request()
            self.obs.watchdog.on_fatal = _halt
        self.start_epoch = 1
        self.best_acc = 0.0
        self.history: List[Dict[str, float]] = []
        if cfg.checkpoint.resume:
            self._try_resume()

    # ------------------------------------------------------------------

    @property
    def global_step(self) -> int:
        return self.state.global_step

    def _payload(self, epoch: int, completed: bool = True) -> Dict:
        """The whole state (a collective on a mesh: every rank calls)."""
        payload = {"model": self.state.full_model_state(),
                   "optimizer": self.state.full_optimizer_state(),
                   "global_step": self.state.global_step,
                   "epoch": epoch, "best_acc": self.best_acc,
                   # False marks a mid-epoch (preemption) save: resume
                   # re-runs that epoch instead of skipping its remaining
                   # data; the step counter goes on either way.
                   "completed": completed, **self._pp_meta()}
        if self.state.ema is not None:
            payload["ema"] = self.state.full_ema()
        return payload

    def _pp_meta(self) -> Dict:
        """tpunet's pipeline metadata (``tpunet/train/loop.py:784-795``):
        the schedule, and the [pipe, virtual] layout of the stored
        stacks, which tpunet sets for an interleaved run's chunk-permuted
        stacks. The port's files hold the whole model in plain layer
        order whatever the schedule, which is tpunet's unpermuted layout
        [0, 0]; so a resume or ``generate`` reads them under any
        ``--mesh-pipe``/``--pp-virtual`` and nothing here is guarded."""
        return {"pp_schedule": self.cfg.model.pp_schedule,
                "pp_layout_pipe": 0, "pp_layout_virtual": 0}

    def _try_resume(self) -> bool:
        restored = self.ckpt.restore_state()
        if restored is None:
            return False
        self.state.load_full_model_state(restored["model"])
        self.state.load_full_optimizer_state(restored["optimizer"])
        if self.state.ema is not None:
            if "ema" not in restored:
                raise ValueError("--ema-decay is set but the checkpoint "
                                 "holds no EMA copies")
            self.state.load_full_ema(restored["ema"])
        self.state.global_step = int(restored["global_step"])
        completed = bool(restored.get("completed", True))
        self.start_epoch = int(restored["epoch"]) + (1 if completed else 0)
        self.best_acc = float(restored["best_acc"])
        flightrec.record("train", f"resume restored epoch="
                                  f"{int(restored['epoch'])} "
                                  f"step={self.state.global_step}")
        log0(f"Resumed from epoch {int(restored['epoch'])}"
             f"{'' if completed else ' (partial)'} "
             f"(best acc {self.best_acc:.4f})")
        return True

    def _to_device(self, array: np.ndarray, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------

    def _sync(self) -> None:
        """The profile window's edge fence: wait for the card's queued
        work (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, bx: np.ndarray, by: np.ndarray, gen) -> M.Metrics:
        return self.train_step(self.state, self._to_device(bx),
                               self._to_device(by, self._label_dtype), gen)

    def _epoch_batches(self, epoch: int):
        cfg = self.cfg
        if self._prefetcher is not None:
            idx = host_index_sequence(
                len(self.train_x), global_batch=cfg.data.batch_size,
                seed=cfg.seed, epoch=epoch, process_index=self.data_rank,
                process_count=self.data_ranks)
            return self._prefetcher.iter_epoch(idx)
        return train_batches(self.train_x, self.train_y,
                             global_batch=cfg.data.batch_size,
                             seed=cfg.seed, epoch=epoch,
                             process_index=self.data_rank,
                             process_count=self.data_ranks)

    # Multi-process preemption polling period (steps): the agreement
    # waits for every rank, so it runs every K steps, in lockstep; a
    # grace window is tens of seconds, far longer than K steps.
    # TPUNET_STOP_POLL_STEPS overrides it (tests stop inside tiny
    # epochs).
    STOP_POLL_STEPS = int(os.environ.get("TPUNET_STOP_POLL_STEPS", "16"))

    def _agree_stop(self, tag: str) -> bool:
        """Cross-rank OR of the local stop flag, through the store."""
        stop = agree_any(tag, self.guard.requested)
        if stop:
            self.guard.request()  # keep the local flag consistent
        return stop

    def _stop_agreed(self) -> bool:
        """The agreed preemption decision at a step boundary: every
        ``STOP_POLL_STEPS`` steps the ranks agree, and all stop if any
        was signalled (a rank that stopped alone would leave the others
        waiting in the step's collectives)."""
        if self.ranks == 1:
            return self.guard.requested
        if self.state.global_step % self.STOP_POLL_STEPS:
            return False
        return self._agree_stop(f"stop/{self.state.global_step}")

    def _epoch_stop_agreed(self, epoch: int) -> bool:
        """One agreement after every epoch: a signal in the epoch's last
        stretch could leave one rank on the partial-save path while the
        others enter eval."""
        if self.ranks == 1:
            return self.guard.requested
        return self._agree_stop(f"estop/{epoch}")

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        every = cfg.log_every_steps
        acc: Optional[M.Metrics] = None
        obs = self.obs
        # Hoisted once per epoch: the disabled path pays exactly one
        # branch per step, no spans, no timer objects, no wrapper
        # around the batch iterator.
        obs_hot = obs.hot
        obs.begin_epoch(epoch)
        batches = self._epoch_batches(epoch)
        if obs_hot:
            batches = timed_batches(
                batches, obs.observe_data_wait,
                wait_ctx=lambda: obs.span("tpunet/data_wait"))
            sync = self._sync
            step_timer = Timer()
        for bx, by in batches:
            if self._stop_agreed():
                break  # preemption: stop at a step boundary
            step = self.state.global_step
            gen = step_generator(cfg.seed, step)
            if obs_hot:
                # Profile-window edge check (the sync fence runs only on
                # the two steps where a window opens/closes), BEFORE the
                # lap starts: a trace's start-up cost stays out of
                # step_time_s. The lap is host-side launch wall time;
                # once the launch queue saturates it converges to the
                # card's step time.
                obs.before_step(step, sync)
                step_timer.lap()
                if self._chaos is not None:
                    # Inside the timed window: an injected straggler delay
                    # shows in step_time_s, where the watchdog looks.
                    self._chaos.step(step)
                with obs.step_span(step):
                    m = self._step(bx, by, gen)
                obs.observe_step(step, step_timer.lap())
            else:
                if self._chaos is not None:
                    self._chaos.step(step)
                m = self._step(bx, by, gen)
            acc = m if acc is None else M.accumulate(acc, m)
            if obs_hot and obs.profiler.running:
                # A window ending exactly at the epoch boundary must
                # close HERE, not on the next epoch's first step —
                # otherwise the trace bleeds across eval/checkpoint.
                obs.profiler.on_step(self.state.global_step, sync)
            if every and self.state.global_step % every == 0:
                sm = M.summarize(m, self._metric_axes)
                # The loss is a host float here anyway — feed the
                # watchdog's NaN/spike detector at no extra sync cost.
                obs.observe_loss(self.state.global_step, sm["loss"])
                lr = self._schedule(self.state.global_step - 1)
                log0(f"  step {self.state.global_step} "
                     f"loss {sm['loss']:.4f} acc {sm['accuracy']:.4f} "
                     f"lr {lr:.3e}")
        return M.summarize(acc if acc is not None
                           else M.zeros_metrics(self.device),
                           self._metric_axes)

    def evaluate(self) -> Dict[str, float]:
        """One pass over the test set, with the EMA weights and BN
        statistics when EMA is on (whole, under FSDP)."""
        with self.state.eval_weights():
            return self._evaluate()

    def _evaluate(self) -> Dict[str, float]:
        cfg = self.cfg
        acc: Optional[M.Metrics] = None
        with self.obs.span("tpunet/eval"):
            for bx, by, bm in eval_batches(
                    self.test_x, self.test_y,
                    global_batch=cfg.data.effective_eval_batch_size,
                    process_index=self.data_rank,
                    process_count=self.data_ranks):
                m = self.eval_step(self.state.model, self._to_device(bx),
                                   self._to_device(by, self._label_dtype),
                                   self._to_device(bm))
                acc = m if acc is None else M.accumulate(acc, m)
        return M.summarize(acc if acc is not None
                           else M.zeros_metrics(self.device),
                           self._metric_axes)

    def evaluate_checkpoint(self) -> Dict[str, float]:
        """``--eval-only``: load the best weights when present (what
        inference serves), else the last full state, and evaluate once."""
        # No step loop drives the profile window here, but a configured
        # window still means "trace this run": open it now; close()
        # stops and writes it.
        prof = self.obs.profiler
        if prof.active and not prof.running:
            prof.on_step(prof.start_step)
        best = self.ckpt.best_path()
        if best is not None:
            self.state.load_full_model_state(state_dict_file(best))
            # With EMA on, best.pth holds the EMA pair, which evaluate()
            # reads from the EMA copies.
            self.state.reset_ema()
        elif not self._try_resume():
            raise FileNotFoundError(
                f"no checkpoint under {self.cfg.checkpoint.directory!r} "
                "(need best.pth or state.pt to --eval-only)")
        return self.evaluate()

    # ------------------------------------------------------------------

    def train(self) -> List[Dict[str, float]]:
        cfg = self.cfg
        loader = "native" if self._prefetcher is not None else "numpy"
        log0(f"Train samples: {len(self.train_x)}")
        log0(f"Test samples: {len(self.test_x)}")
        log0(f"Total parameters: {self.n_params}")
        log0("Host loader: " + ("native C++ prefetcher"
                                if self._prefetcher is not None else "numpy"))
        log0("Starting training...")
        flightrec.record("train", f"starting training loader={loader}")
        log0("")
        metrics_log = MetricsLogger(cfg.checkpoint.directory,
                                    resume=cfg.checkpoint.resume)
        # obs records (obs_epoch / obs_step / obs_alert) share the run's
        # metrics.jsonl; MetricsLogger writes on rank 0 alone.
        self.obs.add_sink(JsonlSink(metrics_log))
        if (self.obs.enabled and self._elastic is not None
                and self._elastic["generation"] > 0):
            # A re-meshed incarnation: the recovery record that pairs with
            # the agent's shrink/grow/restart — the same run_id, the new
            # mesh, and the restore stamp (docs/elasticity.md).
            self.obs.registry.emit(
                "obs_elastic", elastic_events.build_elastic_record(
                    "recovered", generation=self._elastic["generation"],
                    new_world=self.ranks, old_mesh=self._prev_mesh,
                    new_mesh=mesh_shape_dict(self.mesh),
                    epoch=self.start_epoch, step=self.state.global_step))
        # The plain epoch records below bypass Registry.emit, so stamp
        # them here with the same identity.
        identity = self.obs.registry.identity()
        total = Timer()
        self.guard.install()
        try:
            for epoch in range(self.start_epoch, cfg.epochs + 1):
                timer = Timer()
                train_m = self.train_one_epoch(epoch)
                train_secs = timer.elapsed()
                # Watchdog loss checks run BEFORE the NaN guard: the
                # obs_alert record lands in metrics.jsonl even when the
                # guard below aborts the run.
                self.obs.observe_loss(self.state.global_step,
                                      train_m["loss"])
                if not np.isfinite(train_m["loss"]):
                    # The message promises the last completed checkpoint:
                    # make it durable before raising past it.
                    self.ckpt.wait()
                    raise FloatingPointError(
                        f"non-finite train loss ({train_m['loss']}) at "
                        f"epoch {epoch}; the last completed checkpoint is "
                        "still finite — resume from it with a lower --lr")
                if self._epoch_stop_agreed(epoch):
                    if self._stop_epoch(epoch, train_m, train_secs, timer,
                                        metrics_log, identity):
                        break
                test_m = self.evaluate()
                secs = timer.elapsed()
                log0(epoch_line(epoch, cfg.epochs, secs,
                                train_m["loss"], train_m["accuracy"],
                                test_m["loss"], test_m["accuracy"]))
                record = {
                    **identity,
                    "epoch": epoch, "seconds": secs,
                    "step": self.state.global_step,
                    # Throughput over the epoch (eval included) in the
                    # family's unit: next-token predictions for the LM.
                    ("tokens_per_sec" if cfg.is_lm else "examples_per_sec"):
                        round(train_m["count"] / secs, 2),
                    "train_loss": train_m["loss"],
                    "train_accuracy": train_m["accuracy"],
                    "test_loss": test_m["loss"],
                    "test_accuracy": test_m["accuracy"],
                }
                self.history.append(record)
                metrics_log.log(record)
                if test_m["accuracy"] > self.best_acc:
                    self.best_acc = test_m["accuracy"]
                    # With EMA on, the test accuracy was measured on the
                    # EMA weights and BN statistics: save that pair.
                    with self.state.eval_weights():
                        self.ckpt.save_best(
                            self.state.full_model_state(),
                            meta={"model": cfg.model.name,
                                  **self._pp_meta()})
                self.start_epoch = epoch + 1
                self.ckpt.save_state(self._payload(epoch))
                # After the save so this epoch's own checkpoint shows in
                # its cumulative ckpt counters.
                self.obs.end_epoch(
                    epoch=epoch, step=self.state.global_step,
                    units=train_m["count"], train_seconds=train_secs,
                    eval_seconds=secs - train_secs)
            else:
                # Every epoch completed (no preemption or evict stop): the
                # elastic agents stop relaunching a finished run.
                if self._elastic is not None and self.rank == 0:
                    elastic_events.mark_done(cfg.checkpoint.directory)
        finally:
            self.guard.uninstall()
        log0("")
        for line in summary_lines(self.best_acc, total.elapsed()):
            log0(line)
        if self.guard.escalated:
            self.ckpt.abandon()
        else:
            # The durability barrier, bounded by what remains of the
            # preemption grace window (unbounded without one).
            self.ckpt.wait(timeout=self.guard.remaining())
        return self.history

    def _stop_epoch(self, epoch: int, train_m: Dict[str, float],
                    train_secs: float, timer: Timer, metrics_log,
                    identity: Dict) -> bool:
        """The agreed stop after a (possibly cut) epoch; True to leave
        the epoch loop. A second SIGTERM abandons the save; otherwise the
        state is saved marked partial, with a ``partial: true`` record,
        and an agreed watchdog halt then raises."""
        self.start_epoch = epoch
        escalated = self.guard.escalated
        if self.ranks > 1:
            # Escalation is per process; the ranks agree on it too, or
            # one would abandon while the others wait for rank 0's commit.
            escalated = agree_any(f"escalated/{epoch}", escalated)
        if escalated:
            # Second SIGTERM inside the grace window: the platform says
            # NOW. A save cut off mid-write is worse than resuming from
            # the last intact checkpoint, which is what --resume does.
            flightrec.record("train", f"escalated preemption epoch={epoch}")
            log0(f"Second preemption signal at epoch {epoch} (step "
                 f"{self.state.global_step}); abandoning checkpoint work "
                 "and exiting immediately")
            self.ckpt.abandon()
            return True
        # Preempted mid-epoch: persist the advanced state, marked partial
        # so --resume re-runs this epoch's remaining data.
        flightrec.record("train", f"preemption epoch={epoch}")
        if self._evict_requested is not None and self.obs.enabled:
            # The agreed stop is an evict (the marker was claimed at alert
            # time): the breadcrumb that explains it.
            self.obs.registry.emit(
                "obs_elastic", elastic_events.build_elastic_record(
                    "evict_requested",
                    cause=str(self._evict_requested.get("reason",
                                                        "straggler")),
                    epoch=epoch, step=self.state.global_step,
                    detail=self._evict_requested))
        log0(f"Preemption requested at epoch {epoch} (step "
             f"{self.state.global_step}); saving state and exiting")
        self.ckpt.save_state(self._payload(epoch, completed=False),
                             timeout=self.guard.remaining())
        # The eval pass was skipped: the record says so.
        metrics_log.log({
            **identity,
            "epoch": epoch, "partial": True,
            "step": self.state.global_step,
            "seconds": timer.elapsed(),
            "train_loss": train_m["loss"],
            "train_accuracy": train_m["accuracy"],
        })
        self.obs.end_epoch(epoch=epoch, step=self.state.global_step,
                           units=train_m["count"], train_seconds=train_secs,
                           partial=True)
        halted = self._watchdog_halt is not None
        if self.ranks > 1:
            # Every rank learns of the halt, so every rank exits 2.
            halted = agree_any(f"halted/{epoch}", halted)
        if halted:
            # The stop was the watchdog's agreed halt: the state is
            # saved, and the exit must say unhealthy, so an orchestrator
            # that requeues preemptions does not restart a sick run.
            raise RunUnhealthyError(
                f"run unhealthy (agreed multi-process halt): "
                f"{self._watchdog_halt or 'a fatal alert on another rank'}"
                f"; partial state saved at epoch {epoch}")
        return True

    def close(self) -> None:
        """Stop a still-open profile window (writing its trace), drain
        the exporters, close the flight recorder, stop the native
        prefetcher, wait for the checkpoint writer and disarm this
        Trainer's ``--chaos``: the end of a run, or its error path. Each
        step runs even when an earlier one raised."""
        with contextlib.ExitStack() as later:       # runs last to first
            if self._chaos is not None:
                from tpunet_torch.elastic import chaos as chaos_mod
                later.callback(chaos_mod.clear)
            later.callback(self.ckpt.close)
            later.callback(self._close_prefetcher)
            later.callback(set_mesh, None)
            self.obs.close(self._sync)

    def _close_prefetcher(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
