"""Checkpoints of the port: ``.pth`` files, as the reference project writes.

- ``best.pth``: the model's state dict when it reached its best test
  accuracy (the reference's best-by-test-accuracy save); MobileNetV2's
  in torchvision's key layout. It loads into the port with
  ``tpunet_torch.models.convert.load_state_dict_file``, and a
  MobileNetV2's into tpunet with ``tpunet.models.convert.load_pretrained``.
- ``state.pt``: the full state after the last completed epoch (model,
  optimizer, ``global_step``, epoch, ``best_acc``) for ``--resume``.

Each file is written to a temporary name and renamed into place, so a
crash never leaves a partial checkpoint. Under data parallelism rank 0
writes and then every rank passes a barrier, so a file is complete
before any rank goes on; every rank reads the same file when it
restores (tpunet restores on every process). The JAX package's Orbax
layout and its asynchronous saves do not carry over.

With an ``Observability`` (``obs=``), a save runs under the spans
``tpunet/ckpt_dispatch`` (the copy to host memory) and
``tpunet/ckpt_wait`` (the write and the barrier), as tpunet's do; each
``state.pt`` save counts into ``ckpt_saves``, and the host time every
save holds the loop counts into ``ckpt_wait_s`` (a synchronous save
holds it for all of its write), so ``obs_epoch`` carries both.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

from tpunet_torch.config import CheckpointConfig
from tpunet_torch.obs.spans import NULL_SPAN
from tpunet_torch.parallel.dist import sync_hosts
from tpunet_torch.utils.logging import is_coordinator

BEST = "best.pth"
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

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _span(self, name: str):
        return NULL_SPAN if self._obs is None else self._obs.span(name)

    def _save(self, obj: Any, name: str) -> str:
        coordinator = is_coordinator()
        with self._span("tpunet/ckpt_dispatch"):
            snap = _cpu(obj) if coordinator else None
        t0 = time.perf_counter()
        with self._span("tpunet/ckpt_wait"):
            if coordinator:
                os.makedirs(self.directory, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=self.directory,
                                           suffix=".part")
                os.close(fd)
                try:
                    torch.save(snap, tmp)
                    os.replace(tmp, self._path(name))
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            sync_hosts(f"saved-{name}")
        if self._obs is not None:
            self._obs.registry.counter("ckpt_wait_s").inc(
                time.perf_counter() - t0)
        return self._path(name)

    def save_best(self, model: torch.nn.Module) -> str:
        """Write ``best.pth`` (torchvision layout)."""
        return self._save(model.state_dict(), BEST)

    def save_state(self, payload: Dict[str, Any]) -> str:
        """Write ``state.pt``."""
        if self._obs is not None:
            self._obs.registry.counter("ckpt_saves").inc()
        return self._save(payload, STATE)

    def best_path(self) -> Optional[str]:
        path = self._path(BEST)
        return path if os.path.exists(path) else None

    def restore_state(self) -> Optional[Dict[str, Any]]:
        """The saved full state (CPU tensors), or None when there is none."""
        path = self._path(STATE)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)
