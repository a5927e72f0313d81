"""One rank of the port's data-parallel CPU tests (tests/test_torch_dp.py).

    python tests/_torch_dp_worker.py DIR WORLD RANK [lm]

joins a gloo process group of WORLD ranks through a file store in DIR,
runs every case below on this rank's rows of the inputs that the test
wrote into DIR, and saves what it computed to ``DIR/w{WORLD}_rank{RANK}.pt``
(with ``lm``, only the ``lm`` case, to ``DIR/lm_w{WORLD}_rank{RANK}.pt``;
tests/test_torch_lm_train.py):

- ``bn``: one train-mode MobileNetV2 forward/backward (width 0.5, 32 px,
  dropout 0, float32) with ``fused_ir`` on and off, the gradients reduced
  over the ranks: logits, loss, gradients, running statistics;
- ``accum``: one ``fit_batch`` (SGD, lr 1) at gradient accumulation 1
  and 2, of MobileNetV2 and of a tiny ViT (dropout 0): the reduced
  gradients, running statistics and metric sums;
- ``trainer``: ``python -m tpunet_torch.train --preset distributed`` for
  one epoch (this rank's Trainer history and parameters), then, in a new
  group, ``--eval-only`` of its checkpoint (rank 0 prints the line);
- ``lm``: one packed ``fit_lm_batch`` of a tiny LM (SGD, lr 0) at
  gradient accumulation 1 and 2 on this rank's token rows and segment
  ids: the reduced gradients and this rank's metric sums.

Imports no JAX and nothing of the tpunet package.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpunet_torch.config import ModelConfig, OptimConfig  # noqa: E402
from tpunet_torch.models import create_model  # noqa: E402
from tpunet_torch.parallel import dist  # noqa: E402
from tpunet_torch.train import __main__ as cli  # noqa: E402
from tpunet_torch.train.state import (TrainState, make_optimizer,  # noqa: E402
                                      reduce_gradients)
from tpunet_torch.train.steps import fit_batch, fit_lm_batch  # noqa: E402

WIDTH = 0.5
VIT = dict(name="vit", vit_patch=4, vit_hidden=32, vit_depth=2, vit_heads=2,
           dtype="float32", dropout_rate=0.0)
LM = dict(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2, vocab_size=64,
          max_seq_len=80, dtype="float32", dropout_rate=0.0)
# The CLI run of the trainer case: 48 synthetic images at 32 px, 16 a
# global step, 3 steps; 12 test images, one padded eval batch of 16.
# Seed 1: an init whose first-step gradients at 1 and 2 ranks agree far
# inside the test's tolerance; at random init train-mode BN amplifies
# the last bits of its sums, and at many other seeds the two summation
# orders give gradients percent apart (scripts/torch_train_conditioning.py
# shows the effect per image seed).
TRAINER_FLAGS = ["--preset", "distributed", "--dataset", "synthetic",
                 "--synthetic-size", "48", "--image-size", "32",
                 "--width-mult", str(WIDTH), "--dtype", "float32",
                 "--pallas-depthwise", "--epochs", "1", "--seed", "1",
                 "--device", "cpu"]


def _rows(t, world, rank):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def _mnv2(d, fused_ir):
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                     dropout_rate=0.0,
                                     use_pallas_depthwise=True,
                                     fused_ir=fused_ir), device="cpu")
    model.load_state_dict(torch.load(os.path.join(d, "mnv2.pt")))
    return model


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def case_bn(d, x, y, world, rank):
    out = {}
    for fused in (True, False):
        model = _mnv2(d, fused)
        logits = model(x.permute(0, 3, 1, 2), train=True,
                       generator=torch.Generator())
        loss = F.cross_entropy(logits, y)
        loss.backward()
        reduce_gradients(model.parameters())
        out[fused] = dict(logits=logits.detach(), loss=loss.item(),
                          grads=_grads(model), stats=_stats(model))
    return out


def _vit(d):
    model = create_model(ModelConfig(**VIT), device="cpu", image_size=32)
    model.load_state_dict(torch.load(os.path.join(d, "vit.pt")))
    return model


def case_accum(d, x, y, world, rank):
    out = {}
    for name, make in (("mnv2", lambda: _mnv2(d, True)),
                       ("vit", lambda: _vit(d))):
        for accum in (1, 2):
            model = make()
            cfg = OptimConfig(name="sgd", learning_rate=1.0,
                              grad_accum=accum)
            state = TrainState(model, make_optimizer(model.parameters(), cfg),
                               lambda t: 1.0)
            m = fit_batch(state, x, y, torch.Generator(), cfg)
            out[name, accum] = dict(grads=_grads(model), stats=_stats(model),
                                    metrics={k: v.item()
                                             for k, v in m.items()})
    return out


def case_trainer(d, world, rank):
    ck = os.path.join(d, f"ck_w{world}")
    trainer = cli.run(TRAINER_FLAGS + ["--batch-size", str(16 // world),
                                       "--checkpoint-dir", ck])
    assert not dist.is_initialized()        # run() left the group
    out = dict(history=trainer.history,
               params={k: v.clone() for k, v in
                       trainer.state.model.state_dict().items()})
    dist.initialize_distributed(
        init_method="file://" + os.path.join(d, f"store_eval_w{world}"),
        world_size=world, rank=rank, device="cpu")
    cli.run(TRAINER_FLAGS + ["--batch-size", str(16 // world),
                             "--checkpoint-dir", ck, "--eval-only"])
    return out


def case_lm(d, world, rank):
    inputs = np.load(os.path.join(d, "lm_inputs.npz"))
    tokens = _rows(torch.from_numpy(inputs["tokens"]), world, rank)
    segs = _rows(torch.from_numpy(inputs["segs"]), world, rank)
    out = {}
    for accum in (1, 2):
        model = create_model(ModelConfig(**LM), device="cpu")
        model.load_state_dict(torch.load(os.path.join(d, "lm.pt")))
        cfg = OptimConfig(name="sgd", learning_rate=0.0, grad_accum=accum)
        state = TrainState(model, make_optimizer(model.parameters(), cfg),
                           lambda t: 0.0)
        m = fit_lm_batch(state, tokens, segs, torch.Generator(), cfg,
                         packed=True)
        out[accum] = dict(grads=_grads(model),
                          metrics={k: v.item() for k, v in m.items()})
    return out


def main() -> int:
    d, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    if sys.argv[4:] == ["lm"]:
        dist.initialize_distributed(
            init_method="file://" + os.path.join(d, f"store_lm_w{world}"),
            world_size=world, rank=rank, device="cpu")
        out = case_lm(d, world, rank)
        dist.destroy()
        torch.save(out, os.path.join(d, f"lm_w{world}_rank{rank}.pt"))
        return 0
    dist.initialize_distributed(
        init_method="file://" + os.path.join(d, f"store_w{world}"),
        world_size=world, rank=rank, device="cpu")
    assert dist.backend_name() == "gloo"
    inputs = np.load(os.path.join(d, "inputs.npz"))
    x = _rows(torch.from_numpy(inputs["x"]), world, rank)
    y = _rows(torch.from_numpy(inputs["y"]), world, rank)
    calls = dist.all_reduce.calls
    out = {"bn": case_bn(d, x, y, world, rank)}
    out["bn_collectives"] = dist.all_reduce.calls - calls
    out["accum"] = case_accum(d, x, y, world, rank)
    out["trainer"] = case_trainer(d, world, rank)    # leaves the group
    torch.save(out, os.path.join(d, f"w{world}_rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
