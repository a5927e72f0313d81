"""Checkpoints of the port: ``.pth`` files, as the reference project writes.

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

Each file is written to a temporary name and renamed into place, so a
crash never leaves a partial checkpoint. Under data parallelism rank 0
writes and then every rank passes a barrier, so a file is complete
before any rank goes on (a rank never exits while rank 0 still writes);
every rank reads the same file when it restores (tpunet restores on
every process). On a mesh the files hold the whole state, gathered
from the ranks' pieces before rank 0 writes (tpunet's re-mesh restore:
a resume on another mesh cuts it again). The JAX package's Orbax layout and its asynchronous
saves do not carry over: a save is written before the loop goes on. A
``timeout`` (what remains of a preemption's grace window) bounds how
long the loop waits for the write, and :meth:`Checkpointer.abandon`
(a second SIGTERM) stops writing: no later save starts, and a write
still running is never renamed into place.

With an ``Observability`` (``obs=``), a save runs under the spans
``tpunet/ckpt_dispatch`` (the copy to host memory) and
``tpunet/ckpt_wait`` (the write and the barrier), as tpunet's do; each
``state.pt`` save counts into ``ckpt_saves``, and the host time every
save holds the loop counts into ``ckpt_wait_s`` (a synchronous save
holds it for all of its write), so ``obs_epoch`` carries both.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import torch

from tpunet_torch.config import CheckpointConfig
from tpunet_torch.obs.spans import NULL_SPAN
from tpunet_torch.parallel.dist import sync_hosts
from tpunet_torch.utils.logging import is_coordinator

BEST = "best.pth"
BEST_META = "best_meta.json"
STATE = "state.pt"


def _cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig, obs=None):
        self.directory = cfg.directory
        self._obs = obs
        self.abandoned = False

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _span(self, name: str):
        return NULL_SPAN if self._obs is None else self._obs.span(name)

    def _write(self, snap: Any, name: str) -> None:
        """torch.save to a temporary name, renamed into place unless the
        checkpointer was abandoned meanwhile."""
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".part")
        os.close(fd)
        try:
            torch.save(snap, tmp)
            if not self.abandoned:
                os.replace(tmp, self._path(name))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _save(self, obj: Any, name: str,
              timeout: Optional[float] = None) -> Optional[str]:
        if self.abandoned:
            return None
        coordinator = is_coordinator()
        with self._span("tpunet/ckpt_dispatch"):
            snap = _cpu(obj) if coordinator else None
        t0 = time.perf_counter()
        with self._span("tpunet/ckpt_wait"):
            if coordinator and timeout is None:
                self._write(snap, name)
            elif coordinator:
                writer = threading.Thread(target=self._write,
                                          args=(snap, name), daemon=True,
                                          name=f"ckpt-{name}")
                writer.start()
                writer.join(timeout)
                if writer.is_alive():
                    print(f"checkpoint {name} not written within the "
                          f"{timeout:.1f} s left of the grace window; "
                          "abandoning it", flush=True)
                    self.abandon()
            sync_hosts(f"saved-{name}")
        if self._obs is not None:
            self._obs.registry.counter("ckpt_wait_s").inc(
                time.perf_counter() - t0)
        return None if self.abandoned else self._path(name)

    def save_best(self, state_dict: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write ``best.pth``: a model's whole state dict (torchvision's
        layout for MobileNetV2); with ``meta``, rank 0 then writes it to
        ``best_meta.json`` beside it (tpunet's sidecar: the model name and
        its pipeline layout)."""
        path = self._save(state_dict, BEST)
        if path is not None and meta is not None and is_coordinator():
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".part")
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, self._path(BEST_META))
        return path

    def best_meta(self) -> Optional[Dict[str, Any]]:
        """``best_meta.json``, or None when there is none."""
        path = self._path(BEST_META)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save_state(self, payload: Dict[str, Any],
                   timeout: Optional[float] = None) -> Optional[str]:
        """Write ``state.pt``, waiting at most ``timeout`` seconds for
        the write (None: until it is done); its path, or None when the
        save was abandoned."""
        if self._obs is not None:
            self._obs.registry.counter("ckpt_saves").inc()
        return self._save(payload, STATE, timeout)

    def abandon(self) -> None:
        """Stop checkpoint work (a second SIGTERM: the platform kills
        the process next): no save starts after this, and a write still
        in flight is left under its temporary name, so the last intact
        checkpoint stays the one ``--resume`` reads."""
        self.abandoned = True

    def best_path(self) -> Optional[str]:
        path = self._path(BEST)
        return path if os.path.exists(path) else None

    def restore_state(self) -> Optional[Dict[str, Any]]:
        """The saved full state (CPU tensors), or None when there is none."""
        path = self._path(STATE)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)
