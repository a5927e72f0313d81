"""Train and eval steps, port of ``tpunet/train/steps.py`` (image models).

One train step: on-device augmentation -> train-mode forward -> mean
cross-entropy (optionally label-smoothed) -> backward -> optimizer
update -> the metric sums, which stay on the device. All randomness of
the step (augmentation parameters, dropout mask) comes from the one
generator it is given, seeded from (seed, global step) by the trainer.

With ``grad_accum`` > 1 the batch is split into that many microbatches
(``_steps_from_micro``): microbatch i is rows i, i + accum, ... of the
batch, each micro's loss is scaled by 1/accum, and the BN running
statistics update after every micro; one update follows the last.
Under data parallelism the step sees this rank's rows of the global
batch, so a rank's microbatch i is its shard of the global strided
microbatch i; after the last micro every gradient is summed over the
ranks in one flat buffer and divided by their number, then clipped
(``clip_norm``), then applied.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn.functional as F

from tpunet_torch.config import DataConfig, OptimConfig
from tpunet_torch.data.augment import make_eval_preprocess, make_train_augment
from tpunet_torch.parallel.dist import all_reduce, is_initialized, process_count
from tpunet_torch.train import metrics as M
from tpunet_torch.train.state import TrainState


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor,
             smoothing: float) -> torch.Tensor:
    """Per-example CE; torch's ``label_smoothing`` is
    ``optax.smooth_labels``: (1 - s) * one_hot + s / classes."""
    return F.cross_entropy(logits, targets, reduction="none",
                           label_smoothing=smoothing)


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient by its mean over the ranks: one all-reduce
    of one flat buffer, divided by the number of ranks (each rank's
    gradient is that of its rows' mean loss, so the mean over equal
    shards is the global batch's). Nothing to do without a process
    group."""
    if not is_initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    flat.div_(process_count())
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def fit_batch(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
              generator: torch.Generator, optim_cfg: OptimConfig
              ) -> M.Metrics:
    """Forward/backward over ``optim_cfg.grad_accum`` strided microbatches
    of the float images [B,S,S,3] (this rank's rows), the gradients
    reduced over the ranks, one update; returns this rank's metric sums.
    The microbatches draw their dropout masks from ``generator`` in
    turn."""
    accum, n = optim_cfg.grad_accum, labels.shape[0]
    if n % accum:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{accum} microbatches")
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum = correct = 0
    for i in range(accum):
        y = labels[i::accum]
        logits = state.model(images[i::accum].permute(0, 3, 1, 2),
                             train=True, generator=generator)
        loss = _ce_loss(logits, y, optim_cfg.label_smoothing).mean()
        (loss / accum).backward()
        loss_sum = loss_sum + loss.detach() * y.shape[0]
        correct = correct + (logits.detach().argmax(-1) == y).sum()
    reduce_gradients(state.model.parameters())
    state.apply_gradients()
    return M.from_batch(loss_sum, correct, n, labels.device)


def make_train_step(data_cfg: DataConfig, optim_cfg: OptimConfig) -> Callable:
    """train_step(state, images_u8 [B,32,32,3] uint8, labels [B] int64,
    generator) -> metrics; the images and labels (this rank's rows of
    the global batch) on the model's device."""
    augment = make_train_augment(data_cfg)

    def train_step(state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, generator: torch.Generator
                   ) -> M.Metrics:
        return fit_batch(state, augment(generator, images_u8), labels,
                         generator, optim_cfg)

    return train_step


def make_eval_step(data_cfg: DataConfig) -> Callable:
    """eval_step(model, images_u8, labels, mask) -> metrics; ``mask``
    zeroes padded examples so the test set is counted exactly."""
    preprocess = make_eval_preprocess(data_cfg)

    def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor) -> M.Metrics:
        with torch.no_grad():
            logits = model(preprocess(images_u8).permute(0, 3, 1, 2))
            losses = F.cross_entropy(logits, labels, reduction="none")
            correct = (logits.argmax(-1) == labels).float()
            return M.from_batch((losses * mask).sum(),
                                (correct * mask).sum(), mask.sum())

    return eval_step
