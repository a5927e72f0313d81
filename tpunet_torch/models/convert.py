"""Carry MobileNetV2 weights across: Flax trees and ``.pth`` files -> the port.

Port of the parts of ``tpunet/models/convert.py`` the port needs:

- :func:`state_dict_from_jax` mirrors ``export_torch_state_dict``: Flax
  ``params``/``batch_stats`` (as numpy arrays) -> torchvision-layout
  state dict (HWIO -> OIHW, ``scale`` -> ``weight``, ``mean``/``var`` ->
  ``running_*``);
- :func:`load_state_dict` / :func:`load_state_dict_file` load such a
  dict (bare, or under ``state_dict``/``model``/``params``; ``module.``
  prefixes stripped) and, like ``convert_torch_state_dict``, leave the
  head at its fresh init when the checkpoint's class count differs.

From a tpunet checkpoint the user path is
``python -m tpunet.models.convert out.pth`` and then this loader.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpunet_torch.models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS

_HEAD_KEYS = ("classifier.1.weight", "classifier.1.bias")


def _block_specs() -> Tuple[Tuple[str, int, bool], ...]:
    """(flax block name, torch features index, has expand) per block."""
    specs = []
    idx = 0
    for t, _c, n, _s in INVERTED_RESIDUAL_SETTINGS:
        for _ in range(n):
            specs.append((f"block{idx:02d}", idx + 1, t != 1))
            idx += 1
    return tuple(specs)


def _layout():
    """The torchvision MobileNetV2 key layout, as (flax_path, conv_key,
    bn_key) triples."""
    yield ("stem",), "features.0.0", "features.0.1"
    for name, fi, has_expand in _block_specs():
        base = f"features.{fi}.conv"
        if has_expand:
            yield (name, "expand"), f"{base}.0.0", f"{base}.0.1"
            yield (name, "depthwise"), f"{base}.1.0", f"{base}.1.1"
            yield (name, "project"), f"{base}.2", f"{base}.3"
        else:
            yield (name, "depthwise"), f"{base}.0.0", f"{base}.0.1"
            yield (name, "project"), f"{base}.1", f"{base}.2"
    yield ("head",), "features.18.0", "features.18.1"


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def state_dict_from_jax(params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """Flax MobileNetV2 ``params``/``batch_stats`` trees (numpy-convertible
    leaves) -> the port's state dict, CPU float32 tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for flax_path, conv_key, bn_key in _layout():
        node, snode = params, batch_stats
        for p in flax_path:
            node, snode = node[p], snode[p]
        kernel = np.asarray(node["conv"]["kernel"], np.float32)
        sd[f"{conv_key}.weight"] = _t(kernel.transpose(3, 2, 0, 1))  # HWIO->OIHW
        sd[f"{bn_key}.weight"] = _t(node["bn"]["scale"])
        sd[f"{bn_key}.bias"] = _t(node["bn"]["bias"])
        sd[f"{bn_key}.running_mean"] = _t(snode["bn"]["mean"])
        sd[f"{bn_key}.running_var"] = _t(snode["bn"]["var"])
        sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    sd["classifier.1.weight"] = _t(np.asarray(params["classifier"]["kernel"]).T)
    sd["classifier.1.bias"] = _t(params["classifier"]["bias"])
    return sd


def _unwrap(obj: Mapping) -> Dict[str, torch.Tensor]:
    if not any(hasattr(v, "shape") for v in obj.values()):
        for key in ("state_dict", "model", "params"):
            if key in obj:
                obj = obj[key]
                break
    return {k.removeprefix("module."): v for k, v in obj.items()}


def load_state_dict(model: torch.nn.Module, obj: Mapping) -> bool:
    """Load a torchvision-layout state dict into ``model``; returns whether
    the classifier head was loaded. A head of another class count (an
    ImageNet checkpoint's 1000) is skipped and keeps its fresh init;
    every other key must match (``num_batches_tracked`` may be absent)."""
    sd = _unwrap(obj)
    head_ok = tuple(sd["classifier.1.weight"].shape) == tuple(
        model.classifier[1].weight.shape)
    if not head_ok:
        sd = {k: v for k, v in sd.items() if k not in _HEAD_KEYS}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and (head_ok or k not in _HEAD_KEYS)]
    if missing or unexpected:
        raise RuntimeError(f"state dict does not match MobileNetV2: "
                           f"missing {missing}, unexpected {unexpected}")
    return head_ok


def load_state_dict_file(path: str, model: torch.nn.Module) -> bool:
    """Load a ``.pth`` file into ``model`` (see :func:`load_state_dict`)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return load_state_dict(model, obj)
