"""How well conditioned MobileNetV2's train-mode gradients are at random
init, on the CPU: the port against tpunet, and the port against itself.

    JAX_PLATFORMS=cpu python3 scripts/torch_train_conditioning.py \\
        --seeds 9 10 26 --n 8 16

For each numpy seed of the images (standard normal, 32 px) and each
batch size, one float32 train-mode forward/backward of the width-0.5
MobileNetV2 with the weights of ``tests/_torch_port.py``'s
``train_variables(seed=2)``, dropout 0, prints one JSON line: the
largest difference of any gradient, over the largest gradient, between
the port and tpunet (``vs_tpunet``) and between the port on the batch
and the port on its rows reversed (``vs_reversed``: the same function,
float32 sums in another order). The parity tests pick inputs on which
both are small. Imports JAX and tpunet, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from _torch_port import SIZE, WIDTH, train_variables  # noqa: E402
from tpunet.config import ModelConfig as JaxModelConfig  # noqa: E402
from tpunet.models import create_model as jax_create_model  # noqa: E402
from tpunet_torch.config import ModelConfig  # noqa: E402
from tpunet_torch.models import create_model  # noqa: E402
from tpunet_torch.models.convert import (load_state_dict,  # noqa: E402
                                         state_dict_from_jax)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[9, 10, 26])
    p.add_argument("--n", type=int, nargs="+", default=[8, 16])
    a = p.parse_args()
    params, stats = train_variables(seed=2)
    port = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                    dropout_rate=0.0,
                                    use_pallas_depthwise=True), device="cpu")
    assert load_state_dict(port, state_dict_from_jax(params, stats))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH,
                                             dropout_rate=0.0))

    def jax_loss(prm, x, y):
        logits, _ = jmodel.apply({"params": prm, "batch_stats": stats}, x,
                                 train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    jax_grad = jax.jit(jax.grad(jax_loss))

    def port_grads(x, y):
        port.load_state_dict(start)
        port.zero_grad()
        logits = port(torch.from_numpy(x).permute(0, 3, 1, 2), train=True,
                      generator=torch.Generator())
        F.cross_entropy(logits, torch.from_numpy(y)).backward()
        return {k: q.grad.clone() for k, q in port.named_parameters()}

    def worst(got, want):
        gmax = max(float(want[k].abs().max()) for k in got)
        return max(float((got[k] - want[k]).abs().max())
                   for k in got) / gmax

    for seed in a.seeds:
        for n in a.n:
            x = np.random.default_rng(seed).standard_normal(
                (n, SIZE, SIZE, 3)).astype(np.float32)
            y = np.arange(n, dtype=np.int64) % 10
            got = port_grads(x, y)
            want = state_dict_from_jax(jax.tree_util.tree_map(
                np.asarray, jax_grad(params, jnp.asarray(x),
                                     jnp.asarray(y, jnp.int32))), stats)
            rev = port_grads(x[::-1].copy(), y[::-1].copy())
            print(json.dumps({"seed": seed, "n": n,
                              "vs_tpunet": worst(got, want),
                              "vs_reversed": worst(rev, got)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
