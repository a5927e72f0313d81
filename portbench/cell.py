"""One rank of one cell's run: set-up, the measured window, the traced
steps, and (on rank 0) the check against the plain reference.

The program under test is ``tpunet_torch.train.loop.Trainer``: its batch
iterator, its pinned copies and the ``train_step`` of
``make_train_step``, driven by its own ``train_one_epoch`` with
observability off. The harness only wraps three of the Trainer's
methods from outside, to time them and to end a phase:

- ``_epoch_batches``: each ``next()`` is timed (the data wait);
- ``_step``: the host time to the call's return is timed (the dispatch),
  and a CUDA event is recorded after each step's optimizer update;
- ``_stop_agreed``: read, to know when the ranks agreed to stop.

A phase ends through the Trainer's own preemption path: the harness
requests a stop, and ``train_one_epoch`` leaves at a step boundary (with
several ranks, where the ranks agree, every 16 steps). Set-up runs epoch
1 for ``setup_steps`` steps; the first three are the compared ones. The
window then runs whole epochs from epoch 2 on until ``seconds`` have
passed and the ranks have stopped. A traced run then profiles
``trace_steps`` steps with the card's activity alone and as many with
the host's too.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import readers, roofline, traffic, weights
from portbench import trace as trace_mod
from portbench.reference import compare
from portbench.reference import train as reference

COMPARED = 3                      # steps the reference follows
FORBIDDEN = ("jax", "jaxlib", "flax", "tpunet")
EPOCHS = 1000                     # far beyond any window: no last epoch
NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
           "update_gap", "update_gap_median")
NAME_CHARS = 160                  # a kernel's name in the breakdown


def forbidden_modules() -> List[str]:
    """Top-level names of ``sys.modules`` that the port may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Loop:
    """The harness's hooks around one Trainer (module docstring)."""

    def __init__(self, trainer, mix: dict, seconds: float,
                 device: torch.device, counters: Dict[str, str],
                 workdir: str):
        self.t = trainer
        self.workdir = workdir
        self.mix = mix
        self.seconds = seconds
        self.device = device
        self.cuda = device.type == "cuda"
        self.counter_paths = counters
        self.epoch = 0
        self.phase = ""
        self.marks: list = []         # window: step-end events (or clocks)
        self.waits: List[float] = []
        self.laps: List[float] = []
        self.epoch_losses: List[float] = []
        self.loss_sums: list = []
        self.grads: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.traces: List[dict] = []  # the traced steps' two profiles
        self.spans_on = False
        self.counters: Dict[str, float] = {}
        self.n = 0
        self.agreed = False
        self.agreed_at: Optional[int] = None
        self.t0 = 0.0

    # -- hooks ---------------------------------------------------------

    def install(self) -> None:
        t = self.t
        step, batches, stop = t._step, t._epoch_batches, t._stop_agreed

        def timed_step(bx, by, gen):
            self._before()
            t0 = time.perf_counter()
            with self._span("portbench.train_step"):
                m = step(bx, by, gen)
            self._after(m, time.perf_counter() - t0)
            return m

        def timed_batches(epoch):
            it = iter(batches(epoch))
            while True:
                t0 = time.perf_counter()
                try:
                    with self._span("portbench.data_wait"):
                        b = next(it)
                except StopIteration:
                    return
                if self.phase == "window":
                    self.waits.append(time.perf_counter() - t0)
                yield b

        def observed_stop():
            # A phase starts where the last one's agreement was reached:
            # the ranks agreed at that step already (and its keys in the
            # store hold the old answer), so the step is not polled again.
            step = t.state.global_step
            if step == self.agreed_at:
                return False
            agreed = stop()
            if agreed:
                self.agreed, self.agreed_at = True, step
            return agreed

        t._step, t._epoch_batches = timed_step, timed_batches
        t._stop_agreed = observed_stop

    def _span(self, name):
        if self.spans_on:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _request(self) -> None:
        if not self.t.guard.requested:
            self.t.guard.request()

    def _read_counters(self) -> Dict[str, float]:
        return {k: readers.read_counter(p)
                for k, p in self.counter_paths.items()}

    def _profile(self, host: bool):
        acts = ([torch.profiler.ProfilerActivity.CPU]
                if host or not self.cuda else [])
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _before(self) -> None:
        """The traced steps: ``trace_steps`` with the card's activity
        alone (the device time, which the host's own tracing would slow),
        then as many with the host's ops and the harness's spans too."""
        if self.phase != "trace" or self.n not in (0, self.mix["trace_steps"]):
            return
        self._sync()
        if self.n == 0:
            self.counters = self._read_counters()
        self.traces.append({"prof": self._profile(host=self.n > 0),
                            "t0": time.perf_counter()})
        self.spans_on = self.n > 0

    def _end_trace(self) -> None:
        """Stop the open profile and read its trace at once (a later
        profile in the process would take its events)."""
        self._sync()
        tr = self.traces[-1]
        tr["seconds"] = time.perf_counter() - tr["t0"]
        tr["prof"].stop()
        self.spans_on = False
        path = os.path.join(self.workdir, f"trace{len(self.traces)}.json")
        tr.pop("prof").export_chrome_trace(path)
        tr["summary"] = trace_mod.summary(path)
        os.unlink(path)

    def _after(self, m, lap: float) -> None:
        self.n += 1
        if self.phase == "setup":
            opt = self.t.state.optimizer
            b1 = opt.param_groups[0]["betas"][0]
            if self.n <= COMPARED:
                self.loss_sums.append(m["loss_sum"])
            if self.n == 1:
                # The gradient as Adam got it: its first moment after one
                # update is (1 - b1) * g.
                for name, p in self.t.state.model.named_parameters():
                    st = opt.state.get(p, {})
                    g = (st["exp_avg"] / (1.0 - b1) if "exp_avg" in st
                         else torch.zeros_like(p))
                    self.grads[name] = g.detach().to("cpu", torch.float32,
                                                     copy=True)
            if self.n == COMPARED:
                self.params = {name: p.detach().to("cpu", torch.float32,
                                                   copy=True)
                               for name, p
                               in self.t.state.model.named_parameters()}
            if self.n >= self.mix["setup_steps"]:
                self._request()
        elif self.phase == "window":
            self.marks.append(self._mark())
            self.laps.append(lap)
            if time.perf_counter() - self.t0 >= self.seconds:
                self._request()
        elif self.phase == "trace":
            k = self.mix["trace_steps"]
            if self.n == k:
                self._end_trace()
                done = self._read_counters()
                self.counters = {c: done[c] - v
                                 for c, v in self.counters.items()}
            elif self.n == 2 * k:
                self._end_trace()
                self._request()

    # -- phases --------------------------------------------------------

    def run(self, phase: str) -> None:
        """Drive ``train_one_epoch`` from the next epoch on until the
        ranks agree to stop."""
        from tpunet_torch.utils.preemption import PreemptionGuard
        self.t.guard = PreemptionGuard()
        self.phase, self.n, self.agreed = phase, 0, False
        self.t0 = time.perf_counter()
        if phase == "window":
            self.marks = [self._mark()]
        while not self.agreed:
            self.epoch += 1
            out = self.t.train_one_epoch(self.epoch)
            if phase == "window":
                self.epoch_losses.append(out["loss"])
        self._sync()
        self.phase = ""

    def intervals_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in
                    zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def _train_config(cfg: dict, mix: dict, seed: int, world: int, workdir: str):
    from tpunet_torch.config import (CheckpointConfig, DataConfig,
                                     ModelConfig, ObsConfig, OptimConfig,
                                     TrainConfig)
    d = mix["dataset"]
    aug = {k: tuple(v) if isinstance(v, list) else v
           for k, v in mix["augment"].items()}
    data = DataConfig(dataset="synthetic", image_size=cfg["image_size"],
                      batch_size=mix["batch_per_rank"] * world,
                      num_classes=cfg["num_classes"],
                      synthetic_train_size=d["train_rows"],
                      synthetic_test_size=d["test_rows"], **aug)
    return TrainConfig(epochs=EPOCHS, seed=seed, data=data,
                       model=ModelConfig(**cfg["port"]),
                       optim=OptimConfig(**cfg["optim"]),
                       checkpoint=CheckpointConfig(directory=workdir),
                       obs=ObsConfig(enabled=False, flightrec=False))


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _gather(rec: dict, world: int) -> List[dict]:
    if world == 1:
        return [rec]
    import torch.distributed as tdist
    out = [None] * world if tdist.get_rank() == 0 else None
    tdist.gather_object(rec, out, dst=0)
    return out


def _card() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def start(cfg: dict, mix: dict, seed: int, world: int,
          device: torch.device, seconds: float, counters: Dict[str, str],
          workdir: str, stages: Dict[str, float]):
    """Make the inputs from ``seed``, build the Trainer, give it the seeded
    weights, and run set-up (the compared steps among them); returns
    (trainer, loop, data, spec). ``stages``: seconds of each part."""
    from tpunet_torch.train.loop import Trainer

    t = time.perf_counter()
    data = traffic.dataset(mix, seed)
    stages["data"] = time.perf_counter() - t
    t = time.perf_counter()
    trainer = Trainer(_train_config(cfg, mix, seed, world, workdir),
                      dataset=data, device=device.type)
    stages["trainer"] = time.perf_counter() - t
    t = time.perf_counter()
    spec = reference.param_spec(cfg)
    weights.load_into(trainer.state.model, weights.make(spec, seed, device))
    stages["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = Loop(trainer, mix, seconds, device, counters, workdir)
    loop.install()
    loop.run("setup")
    stages["setup_steps"] = time.perf_counter() - t
    return trainer, loop, data, spec


def run_rank(bench: dict, cell: dict, cfg: dict, mix: dict, seed: int,
             seconds: float, traced: bool, rank: int, world: int,
             init_method: Optional[str], device_kind: str,
             t_start: float) -> int:
    """Run one rank; rank 0 prints the result. Returns the exit code."""
    from tpunet_torch.parallel import dist as pdist

    stages = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if device_kind == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        torch.cuda.init()
    else:
        device = torch.device("cpu")
    if world > 1:
        os.environ["LOCAL_RANK"] = str(rank)
        pdist.initialize_distributed(init_method=init_method,
                                     world_size=world, rank=rank,
                                     device=device_kind)
    stages["device"] = time.perf_counter() - t
    workdir = tempfile.mkdtemp(prefix="portbench-")
    counters = {}
    for m in bench["per_layer"]:
        counters.update(getattr(readers.load(m["name"]), "COUNTERS", {}))
    trainer, loop, data, spec = start(cfg, mix, seed, world, device,
                                      seconds, counters, workdir, stages)

    t_window = time.perf_counter()
    setup_s = t_window - t_start
    coll0 = {k: tuple(v) for k, v in pdist.collective_counts().items()}
    loop.run("window")
    window_s = time.perf_counter() - t_window
    coll = {k: (v[0] - coll0[k][0], v[1] - coll0[k][1])
            for k, v in pdist.collective_counts().items()
            if v[0] - coll0[k][0]}
    window_steps = len(loop.marks) - 1
    rec = {"rank": rank, "intervals_ms": loop.intervals_ms(),
           "window_steps": window_steps, "window_s": window_s,
           "epoch_losses": loop.epoch_losses, "stages": stages,
           "loss_sums": [float(v) for v in loop.loss_sums]}
    if traced:
        loop.run("trace")
        device_trace, host_trace = (tr["summary"] for tr in loop.traces)
        rec.update(busy_us=device_trace["busy_us"],
                   trace_s=loop.traces[0]["seconds"],
                   summary=device_trace if rank == 0 else None,
                   host_summary=host_trace if rank == 0 else None,
                   counters=loop.counters)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    rec["forbidden"] = forbidden_modules()
    rec["waits"], rec["laps"], rec["collectives"] = (loop.waits, loop.laps,
                                                     coll)
    recs = _gather(rec, world)
    grads, params3 = loop.grads, loop.params
    trainer.close()
    shutil.rmtree(workdir, ignore_errors=True)
    del trainer, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if world > 1:
        pdist.destroy()
    if rank != 0:
        return 0
    return _report(bench, cell, cfg, mix, seed, traced, world, device, data,
                   spec, recs, grads, params3, setup_s)


def _report(bench, cell, cfg, mix, seed, traced, world, device, data, spec,
            recs, grads, params3, setup_s) -> int:
    found = sorted({m for r in recs for m in r["forbidden"]})
    if found:
        print(f"portbench: the run loaded {found}, which nothing it runs "
              "may import", file=sys.stderr)
        return 3
    r0 = recs[0]
    chips = cell["chips"]
    gb = mix["batch_per_rank"] * world
    steps = r0["window_steps"]
    rate = steps * gb / r0["window_s"] / chips
    intervals = [v for r in recs for v in r["intervals_ms"]]
    losses = [v for r in recs for v in r["epoch_losses"]]
    failed = 0 if all(np.isfinite(losses)) else steps

    # -- the check against the plain reference, after the program ------
    t_ref = time.perf_counter()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    initial = weights.make(spec, seed, device)
    ref = reference.run_steps(cfg, mix, seed, data[0], data[1],
                              {k: v.clone() for k, v in initial.items()},
                              COMPARED, device)
    prog = {"losses": [sum(r["loss_sums"][s] for r in recs) / gb
                       for s in range(COMPARED)],
            "grads": grads, "params": params3}
    nums = compare.numbers(prog, ref, initial)
    ref_s = time.perf_counter() - t_ref
    limits = cfg["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and failed == 0

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": chips,
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in recs)}
    print("portbench: set-up stages (s): " + json.dumps(r0["stages"]),
          file=sys.stderr)
    print(f"portbench: step intervals (ms): median "
          f"{_percentile(intervals, 50)!r} mean "
          f"{sum(intervals) / len(intervals)!r} p95 "
          f"{_percentile(intervals, 95)!r} max {max(intervals)!r}; host "
          f"dispatch mean {1e3 * sum(r0['laps']) / len(r0['laps'])!r}",
          file=sys.stderr)
    print(f"portbench: {cell['name']} seed {seed}: {steps} steps in "
          f"{r0['window_s']:.3f} s, {rate * chips:.2f} samples/s in all, set-up "
          f"{setup_s:.3f} s, reference {ref_s:.3f} s, worst leaves "
          f"{nums['grad_leaf']} (grad) {nums['update_leaf']} (update), "
          f"{nums['left_out_elements']} elements left out of the update, "
          + " ".join(f"{k} {nums[k]!r}" for k in NUMBERS) + ", "
          f"losses {nums['losses']} against {nums['ref_losses']}",
          file=sys.stderr)
    result = {"correct": bool(correct), "attempted": steps, "failed": failed}
    if not traced:
        result["metrics"] = {
            "train_samples_per_sec_per_chip": {"value": rate,
                                               "unit": "samples/s"},
            "step_ms_p95": {"value": _percentile(intervals, 95),
                            "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    else:
        result["metrics"], breakdown = _per_layer(
            bench, cell, cfg, mix, world, recs, rate, name, dev)
        result["breakdown"] = breakdown
        card = _card() if device.type == "cuda" else "cpu"
        launches = {k: v / mix["trace_steps"]
                    for k, v in recs[0]["counters"].items()}
        print("portbench launches a step: " + json.dumps(launches)
              + f" | card: {card}", flush=True)
    result["device"] = dev
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _per_layer(bench, cell, cfg, mix, world, recs, rate, device_name, dev):
    r0 = recs[0]
    mod = reference.model_module(cfg)
    gb = mix["batch_per_rank"]
    ctx = SimpleNamespace(
        config=cfg, traffic=mix, chips=cell["chips"],
        peaks=roofline.peaks(device_name),
        op_calls=mod.op_calls(cfg, gb, cfg["image_size"]),
        flops_per_sample=mod.train_flops_per_sample(cfg, cfg["image_size"]),
        counters=r0["counters"],
        window={"steps": r0["window_steps"], "seconds": r0["window_s"],
                "samples_per_sec_per_chip": rate,
                "data_wait_s": r0["waits"], "dispatch_s": r0["laps"],
                "collectives": r0["collectives"]},
        traced={"steps": mix["trace_steps"], "seconds": r0["trace_s"],
                "summary": r0["summary"], "host_summary": r0["host_summary"],
                "ranks": [{"busy_us": r["busy_us"], "seconds": r["trace_s"]}
                          for r in recs]})
    metrics = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = readers.load(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev["busy_s"] = sum(r["busy_us"] for r in recs) * 1e-6 / len(recs)
    dev["window_s"] = sum(r["trace_s"] for r in recs) / len(recs)
    breakdown = {
        "device_ops": [[n[:NAME_CHARS], us * 1e-6]
                       for n, us in r0["summary"]["device_ops"]],
        "idle_gaps": [[n[:NAME_CHARS], us * 1e-6]
                      for n, us in r0["host_summary"]["idle_gaps"]]}
    return metrics, breakdown
