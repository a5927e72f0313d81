"""Checkpoints of the port: ``.pth`` files, as the reference project writes,
written behind the step loop by one writer thread (tpunet's asynchronous
Checkpointer, ``tpunet/ckpt/orbax_io.py``).

- ``best.pth``: the model's state dict when it reached its best test
  accuracy (the reference's best-by-test-accuracy save); MobileNetV2's
  in torchvision's key layout. It loads into the port with
  ``tpunet_torch.models.convert.load_state_dict_file``, and a
  MobileNetV2's into tpunet with ``tpunet.models.convert.load_pretrained``.
- ``best_meta.json`` (the trainer's): the model name and tpunet's
  pipeline metadata (``pp_schedule``, ``pp_layout_pipe``,
  ``pp_layout_virtual``): the port's files hold the whole model in
  plain layer order under any schedule, tpunet's layout [0, 0].
- ``state.pt``: the full state after the last completed epoch (model,
  optimizer, ``global_step``, epoch, ``best_acc``, the EMA copies when
  EMA is on) for ``--resume``; after a preemption the state of the cut
  epoch, marked ``completed: False`` so that resume re-runs it.
- ``state_meta.json``: the committed save's ``step`` (its epoch, the
  number tpunet's Orbax layout names a step directory by),
  ``global_step`` and ``completed``, renamed into place after
  ``state.pt``. :meth:`Checkpointer.latest_step` and the elastic agent
  read it and never load the tensors.

Each file is written to a temporary ``<name>.<random>.part`` and renamed
into place, so a crash never leaves a partial checkpoint: a write killed
in flight leaves its ``.part`` file, which nothing reads, and the last
intact ``state.pt`` stays the one ``--resume`` reads (tpunet keeps
``state/<step>`` directories, two of them; the port keeps one file that
a torn write never replaces). On a mesh the files hold the whole state,
gathered from the ranks' pieces on the main thread before the dispatch,
in the same order on every rank (tpunet's re-mesh restore: a resume on
another mesh cuts it again). Every rank reads the same file when it
restores.

Asynchronous saves. :meth:`Checkpointer.save_state` and
:meth:`~Checkpointer.save_best` take a snapshot on the caller's thread
and hand the write to one writer thread (registered with the flight
recorder as ``ckpt-writer``); the step loop pays the dispatch. At most
one save is in flight and one queued: a third waits for the oldest
(back-pressure), and only that join and :meth:`~Checkpointer.wait`
count into ``ckpt_wait_s``. A background save that failed raises at the
next save, at ``wait()`` and at ``close()``; it never vanishes.

The snapshot is a clone of every tensor on the caller's current stream
(design (a)): Adam updates the parameters and moments in place, and the
next step's update is queued behind the clone on the same stream, so
the snapshot holds this step's values whatever the loop does next. The
writer then copies the clones into pinned host memory on a stream of
its own, which waits on an event recorded after the clones, and frees
them when the copy is done. The other design, a host copy that the main
stream waits for before its next update, puts the whole device-to-host
copy (a gigabyte for the LM's state) in the step loop's queue; the
clone costs one read and one write of the state at HBM rate, and the
device memory of one state a snapshot, at most two alive by the
back-pressure.

No collective runs on the writer thread. Under data parallelism rank 0
alone writes; its writer publishes "save N committed" (or its error)
under a key of the process group's store, and the other ranks wait on
those keys only in ``wait()``, ``close()`` and the preemption path (the
store handshake of ``tpunet_torch.parallel.dist.agree_any``; tpunet's
Orbax saves end in coordination-service barriers instead).

Transient IO: every save and restore attempt that raises ``OSError`` is
retried ``IO_RETRIES`` times, ``IO_BACKOFF_S`` doubling, with one
``obs_alert`` (reason ``ckpt_io_retry``) a burst and every retry counted
in ``ckpt_io_retries``; any other error propagates untouched. With
``--chaos`` armed, ``save_attempt`` runs before each write attempt,
``save_in_flight`` after ``torch.save`` to the ``.part`` file and before
its rename (the torn-write point) and ``restore_attempt`` before each
read; their ordinals count dispatches of ``state.pt`` saves (1-based)
on the rank that writes. Unarmed, no hook runs.

A ``timeout`` (what remains of a preemption's grace window) bounds a
wait: on expiry the checkpointer goes permanently non-blocking
(:meth:`Checkpointer.abandon`, also a second SIGTERM's path): no later
save starts, a write still running is never renamed into place, and
``wait``/``close`` return at once.

With an ``Observability`` (``obs=``), a dispatch runs under the span
``tpunet/ckpt_dispatch`` and a wait under ``tpunet/ckpt_wait``, as
tpunet's do; each ``state.pt`` save counts into ``ckpt_saves``.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from tpunet_torch.config import CheckpointConfig
from tpunet_torch.obs import flightrec
from tpunet_torch.obs.spans import NULL_SPAN
from tpunet_torch.parallel import dist
from tpunet_torch.utils.logging import is_coordinator

BEST = "best.pth"
BEST_META = "best_meta.json"
STATE = "state.pt"
STATE_META = "state_meta.json"


def emit_io_retry_alert(registry, *, what: str, error: str,
                        max_retries: int, backoff_s: float) -> None:
    """One ``obs_alert`` (reason ``ckpt_io_retry``) a retry burst,
    tpunet's record: the page says checkpoint IO went transiently bad
    before the run either recovers or dies on the exhausted retry."""
    if registry is None:
        return
    registry.counter("obs_alerts").inc()
    registry.emit("obs_alert", {
        "reason": "ckpt_io_retry", "step": 0, "severity": "warn",
        "what": what, "error": error, "max_retries": max_retries,
        "backoff_s": backoff_s,
    })


def _chaos():
    """The installed fault injector (``--chaos``), or None; looked up at
    each IO point, so an unarmed checkpointer runs no hook."""
    from tpunet_torch.elastic import chaos
    return chaos.current()


def _map(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    return obj


def _snapshot(obj: Any) -> Tuple[Any, Optional[Tuple[torch.device,
                                                       torch.cuda.Event]]]:
    """A clone of every tensor of ``obj`` on the current stream, and the
    card and an event recorded after the clones when any lies on one."""
    devices = set()

    def clone(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            devices.add(t.device)
        return t.detach().clone()

    snap = _map(clone, obj)
    if not devices:
        return snap, None
    (device,) = devices
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return snap, (device, event)


class Checkpointer:
    # Transient-IO discipline (tpunet's): an OSError of a save or restore
    # attempt is retried this many times, IO_BACKOFF_S doubling.
    IO_RETRIES = 3
    IO_BACKOFF_S = 0.1

    def __init__(self, cfg: CheckpointConfig, obs=None):
        self.directory = cfg.directory
        self._obs = obs
        self.abandoned = False
        self._pool: Optional[ThreadPoolExecutor] = None
        self._thread = None
        self._stream = None
        self._pending: List = []
        # Store keys of rank 0's commits that this rank has not yet seen
        # (ranks other than 0, under a process group).
        self._commits: List[str] = []
        # 1-based ordinals of state.pt dispatches and of restores: the
        # chaos injector addresses "the K-th save" by them.
        self._save_index = 0
        self._restore_index = 0
        self._dispatches = 0

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _span(self, name: str):
        return NULL_SPAN if self._obs is None else self._obs.span(name)

    def _count(self, name: str, value: float = 1.0) -> None:
        if self._obs is not None:
            self._obs.registry.counter(name).inc(value)

    # -- the writer --------------------------------------------------------

    def _with_io_retry(self, what: str, fn: Callable[[int], Any]) -> Any:
        """``fn(attempt)`` with bounded retry and exponential backoff on
        OSError; any other error propagates untouched (a corrupt file is
        not transient)."""
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except OSError as e:
                attempt += 1
                if attempt > self.IO_RETRIES:
                    raise
                if attempt == 1:
                    emit_io_retry_alert(
                        None if self._obs is None else self._obs.registry,
                        what=what, error=str(e),
                        max_retries=self.IO_RETRIES,
                        backoff_s=self.IO_BACKOFF_S)
                self._count("ckpt_io_retries")
                flightrec.record("ckpt", f"io retry {what} attempt={attempt}")
                time.sleep(self.IO_BACKOFF_S * (2 ** (attempt - 1)))

    def _to_host(self, snap: Any, fence) -> Any:
        """The snapshot in host memory: copied on the writer's own stream
        after ``fence`` (the clones' card and event), into pinned memory,
        then waited for."""
        if fence is None:
            return snap
        device, event = fence
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            host = _map(lambda t: t.to("cpu", non_blocking=True), snap)
        self._stream.synchronize()
        return host

    def _write_file(self, obj: Any, name: str, hook=None) -> None:
        """torch.save to ``<name>.<random>.part``, renamed into place
        unless the checkpointer was abandoned meanwhile; ``hook`` runs
        between the two (the torn-write point)."""
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f"{name}.",
                                   suffix=".part")
        os.close(fd)
        try:
            torch.save(obj, tmp)
            if hook is not None:
                hook()
            if not self.abandoned:
                os.replace(tmp, self._path(name))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _write_json(self, payload: dict, name: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f"{name}.",
                                   suffix=".part")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(name))

    def _make_room(self) -> None:
        """Back-pressure before a snapshot: join finished saves (raising a
        failed one's error) and wait until at most one is left."""
        still = []
        for f in self._pending:
            if f.done():
                f.result()
            else:
                still.append(f)
        self._pending = still
        if len(self._pending) > 1:
            t0 = time.perf_counter()
            while len(self._pending) > 1:
                self._pending[0].result()
                self._pending.pop(0)
            self._count("ckpt_wait_s", time.perf_counter() - t0)

    def _dispatch(self, obj: Any, name: str,
                  write: Callable[[Any], None]) -> None:
        """Snapshot ``obj`` and queue ``write(host_copy)`` on the writer
        (rank 0), then publish the commit under a store key; the other
        ranks note the key they will wait for."""
        self._dispatches += 1
        store = None
        if dist.process_count() > 1:
            import torch.distributed as tdist
            store = tdist.distributed_c10d._get_default_store()
        key = f"tpunet_ckpt/{self.directory}/{name}/{self._dispatches}"
        if not is_coordinator():
            self._commits.append(key)
            return
        self._make_room()
        flightrec.record("ckpt", f"dispatch {name} {self._dispatches}")
        with self._span("tpunet/ckpt_dispatch"):
            snap, fence = _snapshot(obj)
        holder = [snap]
        del snap

        def job() -> None:
            self._thread.beat("busy")
            flightrec.record("ckpt", f"save begin {name}")
            try:
                if self.abandoned:
                    return
                # pop(): the device clones are freed once copied.
                write(self._to_host(holder.pop(), fence))
                if store is not None:
                    store.set(key, "ok")
            except BaseException as e:
                if store is not None:
                    store.set(key, f"error: {e!r}")
                raise
            finally:
                self._thread.beat("idle")
                flightrec.record("ckpt", f"save end {name}")

        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tpunet-ckpt")
            # A sharded state's write can take minutes; past that, page.
            self._thread = flightrec.register_thread(
                "ckpt-writer", stall_after_s=600.0)
        self._pending.append(self._pool.submit(job))

    # -- saves -------------------------------------------------------------

    def save_state(self, payload: Dict[str, Any],
                   timeout: Optional[float] = None) -> Optional[str]:
        """Dispatch ``state.pt`` (then ``state_meta.json``); with a
        ``timeout``, wait at most that long for it to be durable. Its
        path, or None when the checkpointer is (or became) abandoned."""
        if self.abandoned:
            return None
        self._count("ckpt_saves")
        self._save_index += 1
        index = self._save_index
        meta = {"step": payload.get("epoch"),
                "global_step": payload.get("global_step"),
                "completed": payload.get("completed", True)}

        def write(host: Any) -> None:
            def attempt(n: int) -> None:
                chaos = _chaos()
                if chaos is not None:
                    chaos.save_attempt(index, n)
                self._write_file(host, STATE, None if chaos is None else
                                 lambda: chaos.save_in_flight(index))
            self._with_io_retry("save", attempt)
            if not self.abandoned:
                self._write_json(meta, STATE_META)

        self._dispatch(payload, STATE, write)
        if timeout is not None and not self.wait(timeout):
            return None
        return self._path(STATE)

    def save_best(self, state_dict: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Dispatch ``best.pth``: a model's whole state dict (torchvision's
        layout for MobileNetV2); with ``meta``, rank 0 then writes it to
        ``best_meta.json`` beside it (tpunet's sidecar: the model name and
        its pipeline layout)."""
        if self.abandoned:
            return None

        def write(host: Any) -> None:
            self._with_io_retry(
                "save_best", lambda n: self._write_file(host, BEST))
            if meta is not None and not self.abandoned:
                self._write_json(meta, BEST_META)

        self._dispatch(state_dict, BEST, write)
        return self._path(BEST)

    def saving_in_progress(self) -> bool:
        """True while a dispatched save is queued or being written."""
        return any(not f.done() for f in self._pending)

    # -- durability --------------------------------------------------------

    def _drain(self, deadline: Optional[float] = None) -> bool:
        """Join the queued saves and, on ranks other than 0, wait for rank
        0's commits, each joined once: a failed save raises here (and is
        then gone). False when ``deadline`` (``time.perf_counter``) passed
        first."""
        def left() -> Optional[float]:
            return None if deadline is None else \
                max(0.0, deadline - time.perf_counter())

        for f in list(self._pending):
            if not futures_wait([f], timeout=left()).done:
                return False
            self._pending.remove(f)
            f.result()
        if self._commits:
            import torch.distributed as tdist
            store = tdist.distributed_c10d._get_default_store()
            while self._commits:
                key = self._commits[0]
                budget = left()
                try:
                    store.wait([key], dist.TIMEOUT if budget is None
                               else datetime.timedelta(seconds=budget))
                except tdist.DistStoreError:
                    if deadline is None:
                        raise
                    return False
                self._commits.pop(0)
                status = store.get(key).decode()
                if status != "ok":
                    raise RuntimeError(
                        f"rank 0's checkpoint save failed ({key}): {status}")
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every dispatched save is durable (end of run, the
        preemption path). With a ``timeout`` the wait is bounded: on
        expiry it warns and abandons (never blow the platform's grace
        window: a SIGKILL mid-write is worse) and returns False. True when
        everything committed."""
        if self.abandoned:
            return False
        t0 = time.perf_counter()
        flightrec.record("ckpt", "wait begin")
        with self._span("tpunet/ckpt_wait"):
            durable = self._drain(None if timeout is None
                                  else t0 + max(0.0, timeout))
        flightrec.record("ckpt", "wait end")
        self._count("ckpt_wait_s", time.perf_counter() - t0)
        if not durable:
            print(f"checkpoint not written within the {timeout:.1f} s left "
                  "of the grace window; abandoning it", flush=True)
            self.abandon()
        return durable

    def abandon(self) -> None:
        """Stop checkpoint work for good (a second SIGTERM, or a spent
        grace window: the process exits next): no save starts after
        this, a write in flight is left under its temporary name, queued
        ones never run, and ``wait``/``close`` return at once, so the
        last intact checkpoint stays the one ``--resume`` reads."""
        flightrec.record("ckpt", "abandon")
        self.abandoned = True
        self._pending = []
        self._commits = []
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def close(self) -> None:
        """Wait for every save (raising a failed one's error) and stop the
        writer; nothing to do once abandoned."""
        if self.abandoned:
            return
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- reads -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """The step (epoch) of the last committed ``state.pt``, from its
        sidecar: no tensor is loaded."""
        self._drain()
        try:
            with open(self._path(STATE_META)) as f:
                return json.load(f)["step"]
        except FileNotFoundError:
            return None

    def best_meta(self) -> Optional[Dict[str, Any]]:
        """``best_meta.json``, or None when there is none."""
        self._drain()
        path = self._path(BEST_META)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def best_path(self) -> Optional[str]:
        self._drain()
        path = self._path(BEST)
        return path if os.path.exists(path) else None

    def restore_state(self) -> Optional[Dict[str, Any]]:
        """The saved full state (CPU tensors), or None when there is none;
        each read attempt retried on a transient OSError."""
        self._drain()
        path = self._path(STATE)
        if not os.path.exists(path):
            return None
        self._restore_index += 1
        index = self._restore_index

        def read(attempt: int) -> Dict[str, Any]:
            chaos = _chaos()
            if chaos is not None:
                chaos.restore_attempt(index, attempt)
            return torch.load(path, map_location="cpu", weights_only=True)

        return self._with_io_retry("restore", read)
