"""The plain reference of the first training steps.

From the same inputs the benchmark hands the program (the seeded data
set, the seeded weights and the seed), it recomputes what the port's
training steps derive: the step's rows of the epoch's permutation, the
step's random draws, the augmented batch, the forward, the mean
cross-entropy, the gradients, and the Adam update at the schedule's
rate. It runs the global batch of every rank in one process.

The data order and the random draws follow the conventions the port
documents for its training loop, re-derived here from their public
definitions: an epoch's order is numpy's Philox permutation keyed on
(seed, epoch), of which step ``s`` of rank ``r`` takes rows ``s*G +
r*B`` to ``s*G + (r+1)*B``; step ``s`` draws from a CPU
``torch.Generator`` seeded from numpy's ``SeedSequence([seed, 0x5EED,
s])`` (two 32-bit words, the top bit cleared), first the augmentation's
parameters of the global batch, then the model's draws.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import augment
from portbench.reference.precision import CASTS

AUGMENT_STREAM = 0x5EED


def step_generator(seed: int, step: int) -> torch.Generator:
    words = np.random.SeedSequence([seed, AUGMENT_STREAM, step]
                                   ).generate_state(2, np.uint32)
    value = (int(words[0]) << 32 | int(words[1])) & (2 ** 63 - 1)
    return torch.Generator().manual_seed(value)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.Generator(np.random.Philox(key=[seed, epoch])
                               ).permutation(n)


def model_module(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def param_spec(cfg: dict) -> list:
    mod = model_module(cfg)
    if cfg["reference"] == "vit":
        return mod.param_spec(cfg, cfg["image_size"])
    return mod.param_spec(cfg)


def _draw(mod, cfg: dict, gen, n: int, device, data_rank: int):
    if cfg["reference"] == "vit":
        return mod.draw(gen, n, cfg, device, cfg["image_size"], data_rank)
    return mod.draw(gen, n, cfg, device)


def batch(images: np.ndarray, labels: np.ndarray, seed: int, epoch: int,
          step: int, global_batch: int):
    """The global batch of step ``step`` of ``epoch`` (ranks in order)."""
    order = epoch_order(len(images), seed, epoch)
    idx = order[step * global_batch:(step + 1) * global_batch]
    return images[idx], labels[idx]


def run_steps(cfg: dict, traffic: dict, seed: int, images: np.ndarray,
              labels: np.ndarray, params: Dict[str, torch.Tensor],
              steps: int, device: torch.device, precision: str = "float32",
              rows: slice = slice(None), data_rank: int = 0) -> dict:
    """``steps`` training steps of the global batch from ``params``
    (float32, on ``device``; updated in place), the rows of epoch 1 in
    order. Returns the steps' mean losses, the first step's gradients and
    the parameters after the last step (both on ``device``).

    ``precision`` picks the reference (``float32``) or the control
    (``fp8``). ``rows`` and ``data_rank`` serve the faults the tests
    plant: a part of the batch, or one rank's rows alone."""
    mod = model_module(cfg)
    cast: Callable = CASTS[precision]
    opt = cfg["optim"]
    lr, b1, b2, eps = (opt["learning_rate"], opt["b1"], opt["b2"],
                       opt["eps"])
    gb = traffic["batch_per_rank"] * traffic["ranks"]
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for s in range(steps):
        gen = step_generator(seed, s)
        x8, y = batch(images, labels, seed, 1, s, gb)
        n = len(x8)
        p_aug = augment.sample(gen, n, traffic["augment"])
        rand = _draw(mod, cfg, gen, n, device, data_rank)
        sel = np.arange(n)[rows]
        x8, y = x8[sel], y[sel]
        p_aug = {k: v[sel] for k, v in p_aug.items()}
        if "u" in rand:
            rand = {"u": rand["u"][sel]}
        if "masks" in rand:
            rand = {"masks": [mk[sel] for mk in rand["masks"]]}
        xb = augment.apply(torch.from_numpy(x8).to(device), p_aug,
                           traffic["augment"], cfg["image_size"])
        leaves = [params[k].requires_grad_(True) for k in names]
        logits = mod.forward(params, xb, rand, cast, cfg)
        loss = F.cross_entropy(logits, torch.from_numpy(y).long().to(device))
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if s == 0:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        t = s + 1
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                p.requires_grad_(False)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del grads, logits, loss, xb
    return {"losses": losses, "grads": first, "params": params}
