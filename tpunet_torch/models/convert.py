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
- tpunet's pipelined trees (``vit_pp``/``lm_pp``: every block leaf
  stacked on a leading layer dim, ``blocks_*``, MoE stacks of one entry
  a super-layer, chunk-permuted by an interleaved run): both
  ``*_from_jax`` unstack them (:func:`unstack_blocks`, tpunet's
  ``to_transformer_lm_params`` with its ``pipe``/``virtual``), and
  ``lm_params_to_jax``/``vit_params_to_jax`` stack them back
  (:func:`stack_blocks`). The port's own ``vit_pp``/``lm_pp`` files hold
  the plain ``vit``/``lm`` keys in layer order under any schedule;
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


def vit_state_dict_from_jax(params: Mapping, pipe: Optional[int] = None,
                            virtual: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """Flax ViT ``params`` tree (numpy-convertible leaves) -> the port's
    ViT state dict, CPU float32 tensors. The Dense kernel [in, out]
    becomes ``weight`` [out, in] with its output index unchanged, so the
    qkv projection's (3, heads, head_dim) column order is kept. A
    ``vit_pp`` tree (stacked ``blocks_*`` leaves) is unstacked first
    (:func:`unstack_blocks`; ``pipe`` and ``virtual`` for an interleaved
    run's)."""
    params = unstack_blocks(params, pipe, virtual)
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


def lm_state_dict_from_jax(params: Mapping, pipe: Optional[int] = None,
                           virtual: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """Flax LM ``params`` tree (numpy-convertible leaves) -> the port's
    LM state dict, CPU float32 tensors: the token table, the position
    table, the blocks as :func:`vit_state_dict_from_jax` maps them, the
    final LayerNorm; the head is the embedding. An ``lm_pp`` tree
    (stacked ``blocks_*`` leaves, MoE stacks included) is unstacked first
    (:func:`unstack_blocks`; ``pipe`` and ``virtual`` for an interleaved
    run's)."""
    params = unstack_blocks(params, pipe, virtual)
    sd = {"embed.weight": _t(params["embed"]["embedding"]),
          "pos_embed": _t(params["pos_embed"])}
    _blocks(sd, params)
    _ln(sd, "ln", params["ln"])
    return sd


def lm_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                     stacked: bool = False, pipe: Optional[int] = None,
                     virtual: Optional[int] = None) -> dict:
    """The port's LM state dict -> tpunet's Flax LM ``params`` tree of
    float32 numpy arrays, the inverse of :func:`lm_state_dict_from_jax`
    (``weight`` [out, in] -> ``kernel`` [in, out], LayerNorm ``weight``
    -> ``scale``); ``stacked``: ``lm_pp``'s tree (:func:`stack_blocks`,
    chunk-permuted for ``pipe`` x ``virtual`` when given)."""
    a, dense, ln = _jax_leaves(state_dict)
    params = {"embed": {"embedding": a("embed.weight")},
              "pos_embed": a("pos_embed"), "ln": ln("ln")}
    _blocks_to_jax(state_dict, params)
    return stack_blocks(params, pipe, virtual) if stacked else params


def vit_params_to_jax(state_dict: Mapping[str, torch.Tensor],
                      stacked: bool = False, pipe: Optional[int] = None,
                      virtual: Optional[int] = None) -> dict:
    """The port's ViT state dict -> tpunet's Flax ViT ``params`` tree, the
    inverse of :func:`vit_state_dict_from_jax` (the patch kernel OIHW ->
    HWIO); ``stacked``: ``vit_pp``'s tree."""
    a, dense, ln = _jax_leaves(state_dict)
    params = {"patch_embed": {"kernel": np.ascontiguousarray(
                  a("patch_embed.weight").transpose(2, 3, 1, 0)),
                  "bias": a("patch_embed.bias")},
              "pos_embed": a("pos_embed"), "ln": ln("ln"),
              "classifier": dense("classifier")}
    _blocks_to_jax(state_dict, params)
    return stack_blocks(params, pipe, virtual) if stacked else params


def _jax_leaves(state_dict):
    def a(key):
        return state_dict[key].detach().cpu().float().numpy()

    def dense(key):
        return {"kernel": np.ascontiguousarray(a(f"{key}.weight").T),
                "bias": a(f"{key}.bias")}

    def ln(key):
        return {"scale": a(f"{key}.weight"), "bias": a(f"{key}.bias")}
    return a, dense, ln


def _blocks_to_jax(state_dict, params) -> None:
    """``blocks.{i}`` -> the Flax tree's ``block{i:02d}``, into
    ``params``."""
    a, dense, ln = _jax_leaves(state_dict)
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


# -- tpunet's stacked pipeline trees (vit_pp, lm_pp) ------------------------

_LN = (("ln1s", "ln1", "scale"), ("ln1b", "ln1", "bias"),
       ("ln2s", "ln2", "scale"), ("ln2b", "ln2", "bias"))
_ATTN = (("qkv_k", "qkv", "kernel"), ("qkv_b", "qkv", "bias"),
         ("out_k", "out", "kernel"), ("out_b", "out", "bias"))
_FC = (("fc1_k", "fc1", "kernel"), ("fc1_b", "fc1", "bias"),
       ("fc2_k", "fc2", "kernel"), ("fc2_b", "fc2", "bias"))


def _layer_orders(L: int, G: int, pipe, virtual) -> Dict[int, list]:
    """Storage index -> semantic index of each stack length: the blocks'
    [L], the MoE stacks' [G] (whole super-layers a chunk) and the dense
    MLPs' [G * (L/G - 1)], chunk-permuted as tpunet's interleaved runs
    store them (``interleaved_layer_order``); identity without
    ``pipe``."""
    from tpunet_torch.parallel.pp import interleaved_layer_order
    if (pipe is None) != (virtual is None):
        raise ValueError("pass pipe and virtual together (both from "
                         "the interleaved training run) or neither")
    if pipe is None:
        return {n: list(range(n)) for n in {L, G, G * (L // G - 1)}}
    orders = {L: interleaved_layer_order(L, pipe, virtual)}
    if G != L:
        og = interleaved_layer_order(G, pipe, virtual)
        orders[G] = og
        me = L // G
        if me > 1:
            orders[G * (me - 1)] = [g * (me - 1) + o for g in og
                                    for o in range(me - 1)]
    return orders


def unstack_blocks(params: Mapping, pipe: Optional[int] = None,
                   virtual: Optional[int] = None) -> Mapping:
    """tpunet's ``to_transformer_lm_params`` (``tpunet/models/lm_pp.py:544``)
    for both pipelined models: a tree with stacked ``blocks_*`` leaves
    (``vit_pp``/``lm_pp``, MoE stacks ``blocks_moe_*`` of one entry a
    super-layer included) -> the same tree with ``block{i:02d}``
    subtrees in semantic layer order; a tree without stacks is returned
    as it is. ``pipe`` and ``virtual``: the interleaved run's, whose
    stacks are chunk-permuted."""
    if "blocks_qkv_k" not in params:
        if pipe is not None or virtual is not None:
            raise ValueError("pipe/virtual unpermute stacked (blocks_*) "
                             "trees; this tree holds no stacks")
        return params
    L = np.shape(params["blocks_qkv_k"])[0]
    moe = "blocks_moe_wi" in params
    G = np.shape(params["blocks_moe_wi"])[0] if moe else L
    me = L // G if moe else 1
    orders = _layer_orders(L, G, pipe, virtual)
    inv = {n: np.argsort(o) for n, o in orders.items()}

    def at(name, i):
        v = np.asarray(params[f"blocks_{name}"])
        return v[inv[v.shape[0]][i]]

    out = {k: v for k, v in params.items() if not k.startswith("blocks_")}
    for i in range(L):
        blk = {"ln1": {}, "ln2": {}, "attn": {"qkv": {}, "out": {}}}
        for stack, node, leaf in _LN:
            blk[node][leaf] = at(stack, i)
        for stack, node, leaf in _ATTN:
            blk["attn"][node][leaf] = at(stack, i)
        if moe and i % me == me - 1:
            g = i // me
            blk["moe"] = {"router": {"kernel": at("moe_rk", g),
                                     "bias": at("moe_rb", g)},
                          **{n: at(f"moe_{n}", g)
                             for n in MOE_EXPERT_LEAVES}}
        else:
            fi = (i // me) * (me - 1) + i % me if moe else i
            blk["mlp"] = {"fc1": {}, "fc2": {}}
            for stack, node, leaf in _FC:
                blk["mlp"][node][leaf] = at(stack, fi)
        out[f"block{i:02d}"] = blk
    return out


def stack_blocks(params: Mapping, pipe: Optional[int] = None,
                 virtual: Optional[int] = None) -> dict:
    """The inverse of :func:`unstack_blocks`: ``block{i:02d}`` subtrees ->
    tpunet's stacked ``blocks_*`` leaves (chunk-permuted for an
    interleaved run's ``pipe`` and ``virtual``)."""
    L = 0
    while f"block{L:02d}" in params:
        L += 1
    blocks = [params[f"block{i:02d}"] for i in range(L)]
    moe_at = [i for i, b in enumerate(blocks) if "moe" in b]
    G = len(moe_at) or L
    orders = _layer_orders(L, G, pipe, virtual)
    out = {k: v for k, v in params.items() if not k.startswith("block")}

    def stack(name, rows):
        rows = [np.asarray(r, np.float32) for r in rows]
        out[f"blocks_{name}"] = np.stack(
            [rows[j] for j in orders[len(rows)]])

    for name, node, leaf in _LN:
        stack(name, [b[node][leaf] for b in blocks])
    for name, node, leaf in _ATTN:
        stack(name, [b["attn"][node][leaf] for b in blocks])
    dense = [b for b in blocks if "mlp" in b]
    if dense:
        for name, node, leaf in _FC:
            stack(name, [b["mlp"][node][leaf] for b in dense])
    if moe_at:
        moes = [blocks[i]["moe"] for i in moe_at]
        stack("moe_rk", [m["router"]["kernel"] for m in moes])
        stack("moe_rb", [m["router"]["bias"] for m in moes])
        for n in MOE_EXPERT_LEAVES:
            stack(f"moe_{n}", [m[n] for m in moes])
    return out


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


def state_dict_file(path: str, mmap: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The state dict of a ``.pth`` file, on the CPU; ``mmap``: its
    tensors map the file rather than being read into memory."""
    return _unwrap(torch.load(path, map_location="cpu", weights_only=True,
                              mmap=mmap))


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
    if cut and cfg.name in ("vit_pp", "lm_pp"):
        # Only the experts split (EP x PP): the blocks compute whole.
        model.set_expert_parallel(axis_group("model"))
    elif cut:
        n = axis_size("model")
        heads = getattr(model, "heads", 0)
        if heads % n:
            raise ValueError(f"{cfg.name}: {heads} heads do not split over "
                             f"a 'model' axis of {n}")
        model.set_tensor_parallel(axis_group("model"))
    return cut
