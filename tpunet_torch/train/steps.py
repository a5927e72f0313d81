"""Train and eval steps, port of ``tpunet/train/steps.py`` (image models).

One train step: on-device augmentation -> train-mode forward -> mean
cross-entropy (optionally label-smoothed) -> backward -> optimizer
update -> the metric sums, which stay on the device. All randomness of
the step (augmentation parameters, dropout mask) comes from the one
generator it is given, seeded from (seed, global step) by the trainer.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from tpunet_torch.config import DataConfig, OptimConfig
from tpunet_torch.data.augment import make_eval_preprocess, make_train_augment
from tpunet_torch.train import metrics as M
from tpunet_torch.train.state import TrainState


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor,
             smoothing: float) -> torch.Tensor:
    """Per-example CE; torch's ``label_smoothing`` is
    ``optax.smooth_labels``: (1 - s) * one_hot + s / classes."""
    return F.cross_entropy(logits, targets, reduction="none",
                           label_smoothing=smoothing)


def make_train_step(data_cfg: DataConfig, optim_cfg: OptimConfig) -> Callable:
    """train_step(state, images_u8 [B,32,32,3] uint8, labels [B] int64,
    generator) -> metrics; the images and labels on the model's device."""
    augment = make_train_augment(data_cfg)
    smoothing = optim_cfg.label_smoothing

    def train_step(state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, generator: torch.Generator
                   ) -> M.Metrics:
        images = augment(generator, images_u8)
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(images.permute(0, 3, 1, 2), train=True,
                             generator=generator)
        loss = _ce_loss(logits, labels, smoothing).mean()
        loss.backward()
        state.apply_gradients()
        n = labels.shape[0]
        correct = (logits.detach().argmax(-1) == labels).sum()
        return M.from_batch(loss.detach() * n, correct, n, labels.device)

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
