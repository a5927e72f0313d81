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
files, and the ranks meet at a barrier after each write.

Observability (``tpunet_torch.obs``) is threaded through as tpunet's
Trainer does it: per-step host laps, the data-wait split, the profile
window, the watchdog, and one ``obs_epoch`` record an epoch (MFU, CUDA
memory, heartbeat) after the plain record, in the same
``metrics.jsonl``; every record carries the run identity and the
config fingerprint. The default path issues no device sync of its own:
``torch.cuda.synchronize`` runs only at a profile window's two edges.
Not in this slice (ROADMAP Queue A items 2b and 9): preemption, the
agreed multi-process stop, chaos and elastic paths.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tpunet_torch.ckpt import Checkpointer
from tpunet_torch.config import TrainConfig
from tpunet_torch.data import (eval_batches, get_dataset, steps_per_epoch,
                               timed_batches, train_batches)
from tpunet_torch.models import create_model, num_params
from tpunet_torch.models.convert import load_state_dict_file
from tpunet_torch.obs import JsonlSink, Observability
from tpunet_torch.obs.history import train_fingerprint
from tpunet_torch.obs.identity import ensure_run_id
from tpunet_torch.obs.perf import train_flops_per_unit
from tpunet_torch.parallel.dist import (is_initialized, local_device,
                                        process_count, process_index,
                                        sync_hosts)
from tpunet_torch.train import metrics as M
from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
from tpunet_torch.train.steps import (make_eval_step, make_lm_eval_step,
                                      make_lm_train_step, make_train_step)
from tpunet_torch.utils.logging import (MetricsLogger, epoch_line, log0,
                                        summary_lines)
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
        self.device = (local_device(torch.device(device).type)
                       if is_initialized() else torch.device(device))
        self.rank, self.ranks = process_index(), process_count()
        if cfg.obs.halt_on_unhealthy and self.ranks > 1:
            # tpunet stops every process together on a fatal alert
            # (its _agree_stop); that agreement comes with the
            # preemption guard.
            raise NotImplementedError(
                "--halt-on-unhealthy across processes needs the agreed "
                "stop, which is not ported to tpunet_torch yet; it comes "
                "with ROADMAP Queue A item 2b (the preemption guard)")
        ds = dataset if dataset is not None else get_dataset(cfg.data)
        self.train_x, self.train_y, self.test_x, self.test_y = ds
        self.spe = steps_per_epoch(len(self.train_x), cfg.data.batch_size)
        if self.spe == 0:
            raise ValueError("batch size larger than training set")
        model = create_model(cfg.model, device=str(self.device),
                             generator=torch.Generator().manual_seed(cfg.seed),
                             image_size=cfg.data.image_size)
        if cfg.model.pretrained_path:
            load_state_dict_file(cfg.model.pretrained_path, model)
        self._schedule = lr_schedule(cfg.optim, self.spe, cfg.epochs)
        self.state = TrainState(model, make_optimizer(model.parameters(),
                                                      cfg.optim),
                                self._schedule, clip_norm=cfg.optim.clip_norm)
        if cfg.is_lm:
            self.train_step = make_lm_train_step(cfg.optim,
                                                 cfg.data.pack_docs)
            self.eval_step = make_lm_eval_step(cfg.data.pack_docs)
            # Token rows and segment ids go to the device as int32; the
            # image labels as int64 (cross_entropy's class index type).
            self._label_dtype = None
        else:
            self.train_step = make_train_step(cfg.data, cfg.optim)
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
            cfg.model, cfg.data, n_params=num_params(model)))
        self.ckpt = Checkpointer(cfg.checkpoint, obs=self.obs)
        self.start_epoch = 1
        self.best_acc = 0.0
        self.history: List[Dict[str, float]] = []
        if cfg.checkpoint.resume:
            self._try_resume()

    # ------------------------------------------------------------------

    @property
    def global_step(self) -> int:
        return self.state.global_step

    def _payload(self, epoch: int) -> Dict:
        return {"model": self.state.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict(),
                "global_step": self.state.global_step,
                "epoch": epoch, "best_acc": self.best_acc}

    def _try_resume(self) -> bool:
        restored = self.ckpt.restore_state()
        if restored is None:
            return False
        self.state.model.load_state_dict(restored["model"])
        self.state.optimizer.load_state_dict(restored["optimizer"])
        self.state.global_step = int(restored["global_step"])
        self.start_epoch = int(restored["epoch"]) + 1
        self.best_acc = float(restored["best_acc"])
        log0(f"Resumed from epoch {int(restored['epoch'])} "
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
        batches = train_batches(self.train_x, self.train_y,
                                global_batch=cfg.data.batch_size,
                                seed=cfg.seed, epoch=epoch,
                                process_index=self.rank,
                                process_count=self.ranks)
        if obs_hot:
            batches = timed_batches(
                batches, obs.observe_data_wait,
                wait_ctx=lambda: obs.span("tpunet/data_wait"))
            sync = self._sync
            step_timer = Timer()
        for bx, by in batches:
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
                with obs.step_span(step):
                    m = self._step(bx, by, gen)
                obs.observe_step(step, step_timer.lap())
            else:
                m = self._step(bx, by, gen)
            acc = m if acc is None else M.accumulate(acc, m)
            if obs_hot and obs.profiler.running:
                # A window ending exactly at the epoch boundary must
                # close HERE, not on the next epoch's first step —
                # otherwise the trace bleeds across eval/checkpoint.
                obs.profiler.on_step(self.state.global_step, sync)
            if every and self.state.global_step % every == 0:
                sm = M.summarize(m)
                # The loss is a host float here anyway — feed the
                # watchdog's NaN/spike detector at no extra sync cost.
                obs.observe_loss(self.state.global_step, sm["loss"])
                lr = self._schedule(self.state.global_step - 1)
                log0(f"  step {self.state.global_step} "
                     f"loss {sm['loss']:.4f} acc {sm['accuracy']:.4f} "
                     f"lr {lr:.3e}")
        return M.summarize(acc if acc is not None
                           else M.zeros_metrics(self.device))

    def evaluate(self) -> Dict[str, float]:
        cfg = self.cfg
        acc: Optional[M.Metrics] = None
        with self.obs.span("tpunet/eval"):
            for bx, by, bm in eval_batches(
                    self.test_x, self.test_y,
                    global_batch=cfg.data.effective_eval_batch_size,
                    process_index=self.rank, process_count=self.ranks):
                m = self.eval_step(self.state.model, self._to_device(bx),
                                   self._to_device(by, self._label_dtype),
                                   self._to_device(bm))
                acc = m if acc is None else M.accumulate(acc, m)
        return M.summarize(acc if acc is not None
                           else M.zeros_metrics(self.device))

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
            load_state_dict_file(best, self.state.model)
        elif not self._try_resume():
            raise FileNotFoundError(
                f"no checkpoint under {self.cfg.checkpoint.directory!r} "
                "(need best.pth or state.pt to --eval-only)")
        return self.evaluate()

    # ------------------------------------------------------------------

    def train(self) -> List[Dict[str, float]]:
        cfg = self.cfg
        log0(f"Train samples: {len(self.train_x)}")
        log0(f"Test samples: {len(self.test_x)}")
        log0(f"Total parameters: {num_params(self.state.model)}")
        log0("Host loader: numpy")
        log0("Starting training...")
        log0("")
        metrics_log = MetricsLogger(cfg.checkpoint.directory,
                                    resume=cfg.checkpoint.resume)
        # obs records (obs_epoch / obs_step / obs_alert) share the run's
        # metrics.jsonl; MetricsLogger writes on rank 0 alone.
        self.obs.add_sink(JsonlSink(metrics_log))
        # The plain epoch records below bypass Registry.emit, so stamp
        # them here with the same identity.
        identity = self.obs.registry.identity()
        total = Timer()
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            timer = Timer()
            train_m = self.train_one_epoch(epoch)
            train_secs = timer.elapsed()
            # Watchdog loss checks run BEFORE the NaN guard: the
            # obs_alert record lands in metrics.jsonl even when the
            # guard below aborts the run.
            self.obs.observe_loss(self.state.global_step, train_m["loss"])
            if not np.isfinite(train_m["loss"]):
                raise FloatingPointError(
                    f"non-finite train loss ({train_m['loss']}) at epoch "
                    f"{epoch}; the last completed checkpoint is still "
                    "finite — resume from it with a lower --lr")
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
                self.ckpt.save_best(self.state.model)
            self.start_epoch = epoch + 1
            self.ckpt.save_state(self._payload(epoch))
            # After the save so this epoch's own checkpoint shows in its
            # cumulative ckpt counters.
            self.obs.end_epoch(
                epoch=epoch, step=self.state.global_step,
                units=train_m["count"], train_seconds=train_secs,
                eval_seconds=secs - train_secs)
        log0("")
        for line in summary_lines(self.best_acc, total.elapsed()):
            log0(line)
        return self.history

    def close(self) -> None:
        """Stop a still-open profile window (writing its trace), drain
        the exporters and close the flight recorder: the end of a run,
        or its error path."""
        self.obs.close(self._sync)
