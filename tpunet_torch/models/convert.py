"""Carry weights across: Flax trees and ``.pth`` files -> the port.

Port of the parts of ``tpunet/models/convert.py`` the port needs:

- :func:`state_dict_from_jax` mirrors ``export_torch_state_dict``: Flax
  MobileNetV2 ``params``/``batch_stats`` (as numpy arrays) ->
  torchvision-layout state dict (HWIO -> OIHW, ``scale`` -> ``weight``,
  ``mean``/``var`` -> ``running_*``);
- :func:`vit_state_dict_from_jax`: a Flax ViT ``params`` tree -> the
  port's ViT state dict (the patch kernel HWIO -> OIHW, Dense kernels
  transposed to ``weight`` [out, in], LayerNorm ``scale`` -> ``weight``;
  the qkv columns keep their (3, heads, head_dim) order; an MoE block's
  router kernel [d, E] becomes ``moe.router.weight`` [E, d] and its
  experts ``wi``/``bi``/``wo``/``bo`` keep their layouts);
- :func:`lm_state_dict_from_jax`: a Flax LM ``params`` tree -> the
  port's LM state dict (``embed.embedding`` -> ``embed.weight``, the
  blocks as the ViT's, no classifier: the head is tied), and
  :func:`lm_params_to_jax`, its inverse (the serving drafter's npz is
  written in tpunet's layout, ``tpunet_torch/serve/spec.py``);
- :func:`load_state_dict` / :func:`load_state_dict_file` load such a
  dict into any of the models (bare, or under ``state_dict``/``model``/
  ``params``; ``module.`` prefixes stripped) and, like
  ``convert_torch_state_dict``, leave the head at its fresh init when
  the checkpoint's class count differs.

- :func:`shard_state_dict` / :func:`gather_state_dict`: a whole state
  dict -> this rank's pieces of it on the mesh (tensor parallelism's
  'model' splits, FSDP's and ZeRO-1's 'data' splits, as the table of
  ``tpunet_torch.parallel.tp.layout`` says), and back: the pieces of
  every rank gathered into the whole, which is what a checkpoint holds,
  so a run on another mesh (or on one process) reads it unchanged.

From a tpunet MobileNetV2 checkpoint the user path is
``python -m tpunet.models.convert out.pth`` and then this loader; from a
Flax ViT tree, ``vit_state_dict_from_jax`` and then this loader.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tpunet_torch.models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS
from tpunet_torch.parallel import dist
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size
from tpunet_torch.parallel.tp import Shard, join, piece


# An MoE block's expert leaves: the same names and layouts in both
# packages (wi [E, d, h], bi [E, h], wo [E, h, d], bo [E, d]).
MOE_EXPERT_LEAVES = ("wi", "bi", "wo", "bo")


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


def _dense(sd: Dict[str, torch.Tensor], key: str, node: Mapping) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(node["kernel"]).T)
    sd[f"{key}.bias"] = _t(node["bias"])


def _ln(sd: Dict[str, torch.Tensor], key: str, node: Mapping) -> None:
    sd[f"{key}.weight"] = _t(node["scale"])
    sd[f"{key}.bias"] = _t(node["bias"])


def vit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ViT ``params`` tree (numpy-convertible leaves) -> the port's
    ViT state dict, CPU float32 tensors. The Dense kernel [in, out]
    becomes ``weight`` [out, in] with its output index unchanged, so the
    qkv projection's (3, heads, head_dim) column order is kept."""
    pe = params["patch_embed"]
    sd = {"patch_embed.weight": _t(np.asarray(pe["kernel"],
                                              np.float32).transpose(3, 2, 0, 1)),
          "patch_embed.bias": _t(pe["bias"]),
          "pos_embed": _t(params["pos_embed"])}
    _blocks(sd, params)
    _ln(sd, "ln", params["ln"])
    _dense(sd, "classifier", params["classifier"])
    return sd


def _blocks(sd: Dict[str, torch.Tensor], params: Mapping) -> None:
    """The encoder blocks ``block{i:02d}`` -> ``blocks.{i}``."""
    i = 0
    while f"block{i:02d}" in params:
        blk, key = params[f"block{i:02d}"], f"blocks.{i}"
        _ln(sd, f"{key}.ln1", blk["ln1"])
        _dense(sd, f"{key}.attn.qkv", blk["attn"]["qkv"])
        _dense(sd, f"{key}.attn.out", blk["attn"]["out"])
        _ln(sd, f"{key}.ln2", blk["ln2"])
        if "moe" in blk:
            # The router's kernel [d, E] becomes its weight [E, d]; the
            # experts keep tpunet's layouts.
            moe = blk["moe"]
            _dense(sd, f"{key}.moe.router", moe["router"])
            for name in MOE_EXPERT_LEAVES:
                sd[f"{key}.moe.{name}"] = _t(moe[name])
        else:
            _dense(sd, f"{key}.mlp.fc1", blk["mlp"]["fc1"])
            _dense(sd, f"{key}.mlp.fc2", blk["mlp"]["fc2"])
        i += 1


def lm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax LM ``params`` tree (numpy-convertible leaves) -> the port's
    LM state dict, CPU float32 tensors: the token table, the position
    table, the blocks as :func:`vit_state_dict_from_jax` maps them, the
    final LayerNorm; the head is the embedding."""
    if "blocks_qkv_k" in params:
        raise NotImplementedError(
            "lm_pp (pipeline-stacked) checkpoints, their MoE stacks "
            "included, are not ported to tpunet_torch yet; they come with "
            "ROADMAP Queue A item 8d")
    sd = {"embed.weight": _t(params["embed"]["embedding"]),
          "pos_embed": _t(params["pos_embed"])}
    _blocks(sd, params)
    _ln(sd, "ln", params["ln"])
    return sd


def lm_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's LM state dict -> tpunet's Flax LM ``params`` tree of
    float32 numpy arrays, the inverse of :func:`lm_state_dict_from_jax`
    (``weight`` [out, in] -> ``kernel`` [in, out], LayerNorm ``weight``
    -> ``scale``)."""
    def a(key):
        return state_dict[key].detach().cpu().float().numpy()

    def dense(key):
        return {"kernel": np.ascontiguousarray(a(f"{key}.weight").T),
                "bias": a(f"{key}.bias")}

    def ln(key):
        return {"scale": a(f"{key}.weight"), "bias": a(f"{key}.bias")}

    params = {"embed": {"embedding": a("embed.weight")},
              "pos_embed": a("pos_embed"), "ln": ln("ln")}
    i = 0
    while f"blocks.{i}.ln1.weight" in state_dict:
        key = f"blocks.{i}"
        blk = params[f"block{i:02d}"] = {
            "ln1": ln(f"{key}.ln1"),
            "attn": {"qkv": dense(f"{key}.attn.qkv"),
                     "out": dense(f"{key}.attn.out")},
            "ln2": ln(f"{key}.ln2")}
        if f"{key}.moe.router.weight" in state_dict:
            blk["moe"] = {"router": dense(f"{key}.moe.router"),
                          **{n: a(f"{key}.moe.{n}")
                             for n in MOE_EXPERT_LEAVES}}
        else:
            blk["mlp"] = {"fc1": dense(f"{key}.mlp.fc1"),
                          "fc2": dense(f"{key}.mlp.fc2")}
        i += 1
    return params


def _unwrap(obj: Mapping) -> Dict[str, torch.Tensor]:
    if not any(hasattr(v, "shape") for v in obj.values()):
        for key in ("state_dict", "model", "params"):
            if key in obj:
                obj = obj[key]
                break
    return {k.removeprefix("module."): v for k, v in obj.items()}


def load_state_dict(model: torch.nn.Module, obj: Mapping) -> bool:
    """Load a state dict in the port's layout into ``model``; returns
    whether the classifier head (``model.HEAD_KEYS``) was loaded. A head
    of another class count (an ImageNet checkpoint's 1000) is skipped and
    keeps its fresh init; every other key must match
    (``num_batches_tracked`` may be absent)."""
    sd = _unwrap(obj)
    head = model.HEAD_KEYS
    head_ok = not head or tuple(sd[head[0]].shape) == tuple(
        model.get_parameter(head[0]).shape)
    if not head_ok:
        sd = {k: v for k, v in sd.items() if k not in head}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and (head_ok or k not in head)]
    if missing or unexpected:
        raise RuntimeError(f"state dict does not match "
                           f"{type(model).__name__}: missing {missing}, "
                           f"unexpected {unexpected}")
    return head_ok


def state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``.pth`` file, on the CPU."""
    return _unwrap(torch.load(path, map_location="cpu", weights_only=True))


def load_state_dict_file(path: str, model: torch.nn.Module) -> bool:
    """Load a ``.pth`` file into ``model`` (see :func:`load_state_dict`)."""
    return load_state_dict(model, state_dict_file(path))


def shard_tensor(t: torch.Tensor, spec: Optional[Shard]) -> torch.Tensor:
    """This rank's piece of the whole ``t`` under ``spec`` (a copy; ``t``
    itself when ``spec`` is None or its axis has size 1)."""
    if spec is None or axis_size(spec.axis) == 1:
        return t
    return piece(t, spec, axis_size(spec.axis), axis_index(spec.axis))


def gather_tensor(t: torch.Tensor, spec: Optional[Shard]) -> torch.Tensor:
    """The whole tensor of this rank's piece ``t``: every rank's piece,
    gathered over ``spec``'s axis and joined (one collective; ``t`` when
    it is not split)."""
    if spec is None or axis_size(spec.axis) == 1:
        return t
    return join(dist.all_gather(t, axis_group(spec.axis)), spec)


def shard_state_dict(sd: Mapping[str, torch.Tensor],
                     specs: Mapping[str, Optional[Shard]]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's pieces of the whole state dict ``sd``: each key of
    ``specs`` cut as its spec says, every other key as it is."""
    return {k: shard_tensor(v, specs.get(k)) for k, v in sd.items()}


def gather_state_dict(sd: Mapping[str, torch.Tensor],
                      specs: Mapping[str, Optional[Shard]]
                      ) -> Dict[str, torch.Tensor]:
    """The whole state dict of this rank's pieces ``sd``, gathered on
    every rank (a collective per split key: every rank calls it with
    the same keys, in the same order)."""
    return {k: gather_tensor(v, specs.get(k)) for k, v in sd.items()}


def shard_model(model: torch.nn.Module, table, cfg) -> bool:
    """Cut the tensor-parallel leaves of the whole ``model`` for this
    rank of the mesh's 'model' axis, as ``table`` (parameter name ->
    ``LeafLayout``) says, and have its blocks compute as that rank;
    returns whether any leaf was cut. Raises when the heads do not split
    evenly (each rank needs whole heads)."""
    from tpunet_torch.parallel.tp import compute_spec
    cut = False
    for name, p in model.named_parameters():
        spec = compute_spec(table[name])
        if spec is None:
            continue
        cut = True
        p.data = shard_tensor(p.data, spec).contiguous()
    if cut:
        n = axis_size("model")
        heads = getattr(model, "heads", 0)
        if heads % n:
            raise ValueError(f"{cfg.name}: {heads} heads do not split over "
                             f"a 'model' axis of {n}")
        model.set_tensor_parallel(axis_group("model"))
    return cut
