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
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import torch

from tpunet_torch.config import CheckpointConfig
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
    def __init__(self, cfg: CheckpointConfig):
        self.directory = cfg.directory

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, obj: Any, name: str) -> str:
        if is_coordinator():
            os.makedirs(self.directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".part")
            os.close(fd)
            try:
                torch.save(_cpu(obj), tmp)
                os.replace(tmp, self._path(name))
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        sync_hosts(f"saved-{name}")
        return self._path(name)

    def save_best(self, model: torch.nn.Module) -> str:
        """Write ``best.pth`` (torchvision layout)."""
        return self._save(model.state_dict(), BEST)

    def save_state(self, payload: Dict[str, Any]) -> str:
        """Write ``state.pt``."""
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
