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
