"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Seeded tpunet MobileNetV2 variables whose eval BN is neither the
identity nor a collapse of the activations: with the init's running
statistics (mean 0, var 1) the kaiming-initialized network shrinks its
activations to ~1e-9 by the logits, and any comparison passes. So BN
scale/bias are drawn from a numpy generator, the running statistics are
set to the batch statistics of one train-mode pass over a seeded batch,
and then perturbed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict, state_dict_from_jax

WIDTH = 0.5
SIZE = 32


def _map_bn(tree, fn):
    """Apply ``fn(bn_dict) -> bn_dict`` to every ``bn`` node of a tree of
    dicts, returning plain nested dicts of numpy arrays."""
    out = {}
    for k, v in tree.items():
        if k == "bn":
            out[k] = fn({kk: np.asarray(vv, np.float32) for kk, vv in v.items()})
        elif isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _map_bn(v, fn)
        else:
            out[k] = np.asarray(v)
    return out


def jax_variables(seed: int = 0, width_mult: float = WIDTH,
                  image_size: int = SIZE):
    """(params, batch_stats) of a float32 tpunet MobileNetV2, as numpy."""
    model = jax_create_model(JaxModelConfig(dtype="float32",
                                            width_mult=width_mult))
    v = init_variables(model, jax.random.PRNGKey(seed), image_size=image_size)
    rng = np.random.default_rng(seed)

    def affine(bn):
        c = bn["scale"].shape[0]
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, c).astype(np.float32)}

    params = _map_bn(v["params"], affine)
    # Zero running stats: one train-mode pass then leaves exactly
    # (1 - momentum) = 0.1 times the batch statistics behind.
    zeros = _map_bn(v["batch_stats"], lambda bn: {
        k: np.zeros_like(a) for k, a in bn.items()})
    x = rng.normal(size=(4, image_size, image_size, 3)).astype(np.float32)
    _, upd = model.apply({"params": params, "batch_stats": zeros},
                         jnp.asarray(x), train=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(seed)})

    def perturb(bn):
        mean, var = bn["mean"] / 0.1, bn["var"] / 0.1
        c = mean.shape[0]
        return {"mean": (mean + rng.normal(0.0, 0.05, c)
                         * np.sqrt(var)).astype(np.float32),
                "var": (var * rng.uniform(0.8, 1.25, c)).astype(np.float32)}

    stats = _map_bn(upd["batch_stats"], perturb)
    return params, stats


def train_variables(seed: int = 0, width_mult: float = WIDTH,
                    image_size: int = SIZE):
    """(params, batch_stats) for train-mode tests, as numpy: tpunet's own
    init (jitted) with BN scale/bias drawn from numpy, and no train-mode
    pass for the running statistics (the slow part of
    :func:`jax_variables`): train mode reads them only to update them."""
    model = jax_create_model(JaxModelConfig(dtype="float32",
                                            width_mult=width_mult))
    v = jax.jit(lambda key: init_variables(model, key, image_size=image_size)
                )(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def affine(bn):
        c = bn["scale"].shape[0]
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, c).astype(np.float32)}

    return _map_bn(v["params"], affine), _map_bn(v["batch_stats"],
                                                 lambda bn: bn)


def port_model(params, stats, *, use_pallas_depthwise: bool = False,
               width_mult: float = WIDTH):
    """The port's float32 CPU MobileNetV2 holding the JAX weights."""
    model = create_model(ModelConfig(dtype="float32", width_mult=width_mult,
                                     use_pallas_depthwise=use_pallas_depthwise),
                         device="cpu")
    assert load_state_dict(model, state_dict_from_jax(params, stats))
    return model


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy images -> NCHW torch view (channels_last memory)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# -- the LM (tests/test_torch_lm*.py) --------------------------------------

LM = dict(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2, vocab_size=64,
          max_seq_len=80, dtype="float32", dropout_rate=0.0)


def lm_params(seed: int = 0, **overrides):
    """A tiny float32 tpunet LM's params as writable numpy (tpunet's
    init), with every LayerNorm scale drawn from U(0.5, 1.5), every bias
    from N(0, 0.1) and the token table from N(0, 0.5) by a numpy
    generator: Flax's unit/zero LayerNorms, zero biases and N(0, 0.02)
    table give logits near 0, where any comparison passes."""
    cfg = dict(LM, **overrides)
    model = jax_create_model(JaxModelConfig(attention="dense", **cfg))
    v = jax.jit(lambda key: init_variables(model, key, seq_len=16))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def redraw(tree):
        out = {}
        for k, node in tree.items():
            if hasattr(node, "items"):
                out[k] = redraw(node)
                continue
            a = np.array(node, np.float32)
            if k == "scale":
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "bias":
                a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
            elif k == "embedding":
                a = rng.normal(0.0, 0.5, a.shape).astype(np.float32)
            out[k] = a
        return out

    return redraw(v["params"])


def jax_lm(attention: str = "dense", **overrides):
    """tpunet's LM of :data:`LM` with the ``dense`` core, or its flash
    kernel in interpret mode at blocks of 16 (``flash``); causal."""
    import functools

    from tpunet.models.lm import TransformerLM as JaxLM
    from tpunet.ops.flash import flash_attention as jax_flash

    cfg = dict(LM, **overrides)
    if attention == "dense":
        return jax_create_model(JaxModelConfig(attention="dense", **cfg))
    return JaxLM(vocab_size=cfg["vocab_size"], hidden=cfg["vit_hidden"],
                 depth=cfg["vit_depth"], heads=cfg["vit_heads"],
                 max_len=cfg["max_seq_len"],
                 attn_fn=functools.partial(jax_flash, block_q=16,
                                           block_k=16, interpret=True,
                                           causal=True),
                 dtype=jnp.float32, param_dtype=jnp.float32)


def port_lm(params, attention: str = "auto", **overrides):
    """The port's float32 CPU LM holding tpunet's ``params``."""
    from tpunet_torch.models.convert import lm_state_dict_from_jax

    model = create_model(ModelConfig(attention=attention,
                                     **dict(LM, **overrides)), device="cpu")
    load_state_dict(model, lm_state_dict_from_jax(params))
    return model


def packed_segments(rng: np.random.Generator, b: int, t: int) -> np.ndarray:
    """[b, t] int32 segment ids of packed rows: documents 1..k of random
    lengths from position 0, then a tail of padding (0)."""
    segs = np.zeros((b, t), np.int32)
    for r in range(b):
        pos, seg = 0, 0
        end = int(rng.integers(t // 2, t + 1))
        while pos < end:
            n = int(rng.integers(1, 20))
            seg += 1
            segs[r, pos:min(pos + n, end)] = seg
            pos += n
    return segs
