"""Train state and optimization stack, port of ``tpunet/train/state.py``.

The reference's stack is CrossEntropyLoss + Adam(lr=1e-4) +
StepLR(step_size=10, gamma=0.1). tpunet writes StepLR as an optax
piecewise-constant schedule over steps; :func:`lr_schedule` is that
schedule as a plain function of the 0-based update index, and the train
step sets each update's learning rate from it. The update at index
``10 * steps_per_epoch`` is the first at the decayed rate, as with
torch's per-epoch ``StepLR``. ``clip_norm`` > 0 puts optax's
``clip_by_global_norm`` before the optimizer, as tpunet chains it.

Parameter EMA (``ema_decay`` > 0, tpunet's ``ema_params`` and
``ema_batch_stats``): copies of the parameters and of the floating
buffers (BN running statistics), made at the start, are moved after
every update by ``e = d*e + (1-d)*p`` over the post-update values (one
``torch._foreach_lerp_``); :meth:`TrainState.ema_weights` puts them in
the model for eval and the best checkpoint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Iterable, Iterator, List

import torch

from tpunet_torch.config import OptimConfig

Schedule = Callable[[int], float]


def lr_schedule(cfg: OptimConfig, steps_per_epoch: int,
                epochs: int) -> Schedule:
    """Step-indexed learning rate: ``schedule(t)`` is the rate of update
    ``t`` (0-based).

    ``step``: the base rate times ``gamma`` for every boundary at
    ``step_size_epochs``, ``2*step_size_epochs``, ... epochs (up to
    ``epochs``) with ``t >= boundary``; ``cosine``: decays to 0 over the
    steps after warmup; ``constant``. A linear warmup over
    ``warmup_epochs`` (fractional allowed) from 0 comes first, and the
    base schedule's clock starts when it ends (optax.join_schedules)."""
    total = steps_per_epoch * epochs
    warm = int(round(cfg.warmup_epochs * steps_per_epoch))
    lr = cfg.learning_rate
    if cfg.schedule == "step":
        bounds = [e * steps_per_epoch
                  for e in range(cfg.step_size_epochs, epochs + 1,
                                 cfg.step_size_epochs)]

        def base(t: int) -> float:
            v = lr
            for b in bounds:
                if t >= b:
                    v *= cfg.gamma
            return v
    elif cfg.schedule == "cosine":
        decay = max(1, total - warm)

        def base(t: int) -> float:
            frac = min(max(t, 0), decay) / decay
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    elif cfg.schedule == "constant":
        def base(t: int) -> float:
            return lr
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}; "
                         "expected step|cosine|constant")
    if warm <= 0:
        return base

    def warmed(t: int) -> float:
        if t < warm:
            return lr * max(t, 0) / warm
        return base(t - warm)
    return warmed


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: OptimConfig) -> torch.optim.Optimizer:
    """The optimizer of tpunet's ``make_optimizer``: Adam (with
    ``weight_decay`` 0), else AdamW with decoupled decay, or SGD with
    momentum 0.9. eps sits outside the square root, as in optax. The
    learning rate is set before every update from :func:`lr_schedule`."""
    params = list(params)
    if cfg.name == "adam" and cfg.weight_decay == 0.0:
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(cfg.b1, cfg.b2), eps=cfg.eps)
    if cfg.name in ("adam", "adamw"):
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                                 weight_decay=cfg.weight_decay)
    if cfg.name == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=0.9)
    raise ValueError(f"unknown optimizer {cfg.name!r}")


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and without a host sync:
    every gradient times ``max_norm / norm`` when the L2 norm of all of
    them together is at least ``max_norm``, else unchanged (no epsilon
    and no clamp, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the schedule, the global-norm clip (0 =
    off), the number of updates taken (``global_step``, the index of
    the next update) and the EMA decay (0 = off)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    global_step: int = 0
    clip_norm: float = 0.0
    ema_decay: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.ema_decay < 1.0:
            # decay >= 1 freezes the EMA at the init, and eval and the
            # best checkpoint would measure that forever.
            raise ValueError(f"ema_decay must be in [0, 1), got "
                             f"{self.ema_decay}")
        self.reset_ema()

    def ema_sources(self) -> List[torch.Tensor]:
        """What the EMA follows: every parameter, then every floating
        buffer (the BN running statistics), in module order."""
        return list(self.model.parameters()) + [
            b for b in self.model.buffers() if b.is_floating_point()]

    def reset_ema(self) -> None:
        """The EMA copies := the model's current values (None when off)."""
        self.ema = ([t.detach().clone() for t in self.ema_sources()]
                    if self.ema_decay > 0 else None)

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[None]:
        """Inside, the model holds the EMA copies (parameters and BN
        statistics as a pair, as tpunet evaluates them); the live values
        return on exit. Nothing changes when EMA is off."""
        if self.ema is None:
            yield
            return
        src = self.ema_sources()
        live = [t.data for t in src]
        for t, e in zip(src, self.ema):
            t.data = e
        try:
            yield
        finally:
            for t, d in zip(src, live):
                t.data = d

    def apply_gradients(self) -> None:
        """One optimizer update at the schedule's rate for this step,
        after the clip; then the EMA step."""
        if self.clip_norm > 0:
            clip_by_global_norm([p.grad for p in self.model.parameters()
                                 if p.grad is not None], self.clip_norm)
        lr = self.schedule(self.global_step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.global_step += 1
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_lerp_(
                    self.ema, [t.detach() for t in self.ema_sources()],
                    1.0 - self.ema_decay)
