"""Train and eval steps, port of ``tpunet/train/steps.py``.

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

With mixup or CutMix (``DataConfig.mixup_alpha``/``cutmix_alpha``)
each microbatch is mixed after the augment (``data.augment.make_mix``,
its draws from the same generator, before the dropout mask's) and its
loss is ``lam * CE(y) + (1 - lam) * CE(y_b)`` with the same label
smoothing; accuracy counts against the primary label ``y``. With both
alphas at 0 nothing more is drawn, so the generator stream is that of a
run without them.

The LM's steps (:func:`make_lm_train_step`, :func:`make_lm_eval_step`)
predict the input shifted by one and count next-token predictions. With
packed documents the labels are [B, T] segment ids: the core masks
attention to same-segment pairs and the loss drops targets that cross a
document boundary or land on padding; the CE is summed over the valid
targets and divided by the global batch's valid count (tpunet's
``count_fn`` contract), so microbatch gradients are summed, not
averaged, and each rank scales its sum by the world size, which
``TrainState.reduce_gradients`` divides out.

On a mesh (``tpunet_torch.parallel.mesh``) "the ranks" above are the
'data' axis: its ranks split the batch, and the gradients and metric
sums are reduced over its group only; the ranks of a 'model' group see
the same rows and compute one step together (tensor parallelism). A
sharded state (``TrainState.sharding``) gathers the FSDP parameters at
the step's start (``begin_step``), reduce-scatters the split gradients
(``TrainState.reduce_gradients``) and updates the pieces. With
``vocab_ce`` resolving to ``sharded`` (``--vocab-ce``; ``auto`` on a
'model' axis that divides the vocab) the LM returns its hidden states
and the CE runs vocab-parallel against the tied embedding
(``tpunet_torch.ops.vocab_ce``): the [B, T, V] logits never exist whole.

A pipelined model (``vit_pp``/``lm_pp`` on a 'pipe' axis, the model's
``pp`` plan) goes through the same :func:`fit_batch` / :func:`fit_lm_batch`:
each accumulation microbatch (the strided rows above) is one run of the
pipeline schedule over ``pp_microbatches`` contiguous microbatches
(gradient accumulation wraps the whole pipeline), the loss of a
microbatch (:func:`_cls_loss`, :func:`_lm_microbatch_loss`, as without
a pipeline) is computed on the last stage inside the schedule (its
backward starts there), and each MoE term of a stage's chunk joins its
microbatch's backward weighted ``moe_aux_weight / (M * seq * accum)``
(tpunet's sum over stages and mean over microbatches and shards). The
metric sums are the last stage's (each stage adds its own MoE terms'
share) and are summed over 'pipe' at the step's end, so every rank holds
the same numbers as an unpipelined step's.

The steps put tpunet's phase names around their work as
``record_function`` ranges (``tpunet_torch.obs.spans.span``):
``tpunet_augment`` (the augment and the mixing), ``tpunet_fwd_bwd``
(the forwards, the backwards and the gradients' reduction),
``tpunet_optimizer`` and ``tpunet_ema`` (``TrainState.apply_gradients``)
and ``tpunet_eval_forward``, which ``tpunet_torch.obs.trace_phase``
reads from a profiled window.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpunet_torch.config import DataConfig, OptimConfig
from tpunet_torch.data.augment import (make_eval_preprocess, make_mix,
                                      make_train_augment)
from tpunet_torch.obs.spans import span
from tpunet_torch.ops.vocab_ce import vocab_parallel_ce
from tpunet_torch.parallel.dist import all_reduce
from tpunet_torch.parallel.mesh import axis_group, axis_size
from tpunet_torch.parallel.pp import split_micro
from tpunet_torch.train import metrics as M
from tpunet_torch.train.state import TrainState


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor,
             smoothing: float) -> torch.Tensor:
    """Per-example CE; torch's ``label_smoothing`` is
    ``optax.smooth_labels``: (1 - s) * one_hot + s / classes."""
    return F.cross_entropy(logits, targets, reduction="none",
                           label_smoothing=smoothing)


def _aux_term(model: torch.nn.Module, weight: float):
    """``weight`` times the MoE load-balance terms of ``model``'s last
    training forward (tpunet's ``_aux_term``), 0.0 without MoE blocks or
    at weight 0. The term is the global batch's on every rank."""
    read = getattr(model, "moe_aux_loss", None)
    terms = read() if read is not None else None
    if terms is None or weight <= 0:
        return 0.0
    return weight * terms


def _mixed(mix: Optional[Callable], generator: torch.Generator,
           x: torch.Tensor, y: torch.Tensor):
    """``(x, mixed)``: the microbatch mixed by ``mix`` (from ``make_mix``)
    with ``mixed`` its partner labels and ``lam`` as a tensor, or ``x``
    as given and None without ``mix``."""
    if mix is None:
        return x, None
    x, y_b, lam = mix(generator, x, y)
    return x, (y_b, torch.tensor(lam, dtype=torch.float32, device=x.device))


def _cls_loss(logits: torch.Tensor, y: torch.Tensor, mixed,
              smoothing: float):
    """Per-example CE of ``logits`` against ``y`` (``lam * CE(y) + (1 -
    lam) * CE(y_b)`` when ``mixed``) and the hits against ``y``; the one
    loss of :func:`fit_batch`, pipelined or not."""
    ce = _ce_loss(logits, y, smoothing)
    if mixed is not None:
        y_b, lam = mixed
        ce = lam * ce + (1.0 - lam) * _ce_loss(logits, y_b, smoothing)
    return ce, (logits.detach().argmax(-1) == y).sum()


def _pipe_metrics(loss_sum, correct, count, device) -> M.Metrics:
    """A pipelined step's metric sums, summed over 'pipe' (the last
    stage's loss, hits and count; every stage's MoE share)."""
    sums = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                        for v in (loss_sum, correct, count)])
    loss_sum, correct, count = all_reduce(sums, axis_group("pipe")).unbind()
    return M.from_batch(loss_sum, correct, count, device)


def fit_batch(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
              generator: torch.Generator, optim_cfg: OptimConfig,
              mix: Optional[Callable] = None,
              aux_weight: float = 0.0) -> M.Metrics:
    """Forward/backward over ``optim_cfg.grad_accum`` strided microbatches
    of the float images [B,S,S,3] (this rank's rows), the gradients
    reduced over the ranks, one update; returns this rank's metric sums.
    The microbatches draw their mixing (``mix``, from ``make_mix``) and
    dropout masks from ``generator`` in turn. An MoE model's loss (and
    its metric) adds ``aux_weight`` times the load-balance terms. A
    pipelined model (``vit_pp``, no MoE blocks) runs each microbatch as
    one pipeline run, the same loss on the last stage (module
    docstring)."""
    accum, n = optim_cfg.grad_accum, labels.shape[0]
    if n % accum:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{accum} microbatches")
    smoothing = optim_cfg.label_smoothing
    seq = axis_size("seq")
    model = state.model
    pp = getattr(model, "pp", None)
    with span("tpunet_fwd_bwd"):
        state.zero_grad()
        state.begin_step()
        loss_sum = correct = 0
        for i in range(accum):
            x, y = images[i::accum], labels[i::accum]
            with span("tpunet_augment"):
                x, mixed = _mixed(mix, generator, x, y)
            if pp is not None:
                ys = split_micro(y, pp.M)
                mixes = ([None] * pp.M if mixed is None else
                         [(y_b, mixed[1])
                          for y_b in split_micro(mixed[0], pp.M)])
                rows = y.shape[0]

                def loss_fn(m, logits):
                    nonlocal loss_sum, correct
                    ce, hits = _cls_loss(logits, ys[m], mixes[m], smoothing)
                    loss_sum = loss_sum + ce.detach().sum()
                    correct = correct + hits
                    return ce.sum() / (rows * accum)

                model.pipe_train(x.permute(0, 3, 1, 2), generator, loss_fn)
                continue
            logits = model(x.permute(0, 3, 1, 2), train=True,
                           generator=generator)
            ce, hits = _cls_loss(logits, y, mixed, smoothing)
            loss = ce.mean() + _aux_term(model, aux_weight)
            # Under sequence parallelism every rank of a 'seq' group holds
            # the whole logits (the ViT's pool sums over the group): each
            # takes 1/S of the loss, so that the gradients summed over 'seq'
            # are the loss's.
            (loss / (accum * seq)).backward()
            loss_sum = loss_sum + loss.detach() * y.shape[0]
            correct = correct + hits
        state.reduce_gradients()
    state.apply_gradients()
    if pp is not None:
        return _pipe_metrics(loss_sum, correct,
                             n if pp.s == pp.S - 1 else 0, labels.device)
    return M.from_batch(loss_sum, correct, n, labels.device)


def make_train_step(data_cfg: DataConfig, optim_cfg: OptimConfig,
                    aux_weight: float = 0.0) -> Callable:
    """train_step(state, images_u8 [B,32,32,3] uint8, labels [B] int64,
    generator) -> metrics; the images and labels (this rank's rows of
    the global batch) on the model's device; ``aux_weight`` weighs an
    MoE model's load-balance terms."""
    augment = make_train_augment(data_cfg)
    mix = make_mix(data_cfg)

    def train_step(state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, generator: torch.Generator
                   ) -> M.Metrics:
        with span("tpunet_augment"):
            images = augment(generator, images_u8)
        return fit_batch(state, images, labels, generator, optim_cfg, mix,
                         aux_weight)

    return train_step


def _packed_target_weights(segs: torch.Tensor) -> torch.Tensor:
    """[B, T-1] float32 weights of next-token prediction under packing: a
    target is valid iff it continues the same document (segment id
    unchanged) and is not padding (id 0)."""
    return ((segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] != 0)).float()


def _targets(model: torch.nn.Module, t: int) -> slice:
    """The next-token targets of this rank's positions among a row's
    T - 1 (positions 0..T-2 predict tokens 1..T-1): all of them, or
    under sequence parallelism those of shard r of n. Every rank holds
    the whole row, so rank r's last position predicts the first token
    of rank r + 1's shard, and only the row's last position has none."""
    n, r = model.seq_shard()
    lo = r * (t // n)
    return slice(lo, min(lo + t // n, t - 1))


def _lm_ce(model: torch.nn.Module, out: torch.Tensor, tokens: torch.Tensor,
           smoothing: float, sharded_ce: bool = False):
    """Per-target CE [B, targets] and whether the argmax hits, of the
    model's output ``out`` at this rank's positions (:func:`_targets`;
    0..T-2 on one rank) against the next tokens of ``tokens``: ``out``
    is the logits, or under ``sharded_ce`` the hidden states, whose CE
    runs vocab-parallel over the 'model' axis."""
    sl = _targets(model, tokens.shape[1])
    n_tgt = sl.stop - sl.start
    nxt = tokens[:, 1:][:, sl]
    if sharded_ce:
        return vocab_parallel_ce(out[:, :n_tgt], model.embed.weight, nxt,
                                 axis_group("model"), smoothing=smoothing)
    logits = out[:, :n_tgt]
    tgt = nxt.long()
    ce = _ce_loss(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1),
                  smoothing).view_as(tgt)
    return ce, logits.detach().argmax(-1) == tgt


def _next_token(model: torch.nn.Module, tokens: torch.Tensor, segs,
                smoothing: float, sharded_ce: bool = False, **kw):
    """:func:`_lm_ce` of the model's forward over ``tokens``."""
    if sharded_ce:
        kw["return_hidden"] = True
    out = model(tokens, segment_ids=segs, **kw)
    return _lm_ce(model, out, tokens, smoothing, sharded_ce)


def _lm_microbatch_loss(model: torch.nn.Module, out: torch.Tensor,
                        tokens: torch.Tensor, segs, smoothing: float,
                        sharded_ce: bool):
    """One microbatch's CE sum (in the graph) and its metric's hits and
    targets, from the model's output ``out`` (:func:`_lm_ce`): over
    every target, or with ``segs`` (packed) over the valid ones. The one
    loss of :func:`fit_lm_batch`, pipelined or not."""
    ce, hit = _lm_ce(model, out, tokens, smoothing, sharded_ce)
    if segs is None:
        return ce.sum(), hit.sum(), ce.numel()
    wt = _packed_target_weights(segs)[:, _targets(model, tokens.shape[1])]
    return (ce * wt).sum(), (hit * wt).sum(), wt.sum()


def fit_lm_batch(state: TrainState, tokens: torch.Tensor,
                 labels: torch.Tensor, generator: torch.Generator,
                 optim_cfg: OptimConfig, packed: bool = False,
                 sharded_ce: bool = False,
                 aux_weight: float = 0.0) -> M.Metrics:
    """The LM's :func:`fit_batch`: forward/backward over
    ``optim_cfg.grad_accum`` strided microbatches of the token rows
    [B, T] (this rank's), the gradients reduced over the ranks, one
    update; returns this rank's metric sums. ``packed``: ``labels``
    are the rows' segment ids; each microbatch's CE sum is divided by
    the global valid-target count (summed over the ranks first) and
    multiplied by the world size.

    An MoE model's weighted load-balance term ``aux`` (the global
    batch's, alike on every rank) joins each microbatch's loss as
    tpunet's does: ``ce.mean() + aux`` unpacked, ``ce_sum / total +
    aux / accum`` packed; a 'seq' rank takes 1/S of it, since the 'seq'
    ranks' losses are summed. The metric's loss sum carries it as
    tpunet's: ``aux`` times the targets (unpacked), ``aux * total /
    accum`` (packed).

    A pipelined model (``lm_pp``) runs each microbatch as one pipeline
    run over ``pp_microbatches`` pieces, each piece's loss (the same
    :func:`_lm_microbatch_loss`, scaled alike) on the last stage, and
    each stage's MoE terms join the backward and the metric (module
    docstring)."""
    accum, n = optim_cfg.grad_accum, tokens.shape[0]
    if n % accum:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{accum} microbatches")
    smoothing = optim_cfg.label_smoothing
    model = state.model
    pp = getattr(model, "pp", None)
    with span("tpunet_fwd_bwd"):
        state.zero_grad()
        state.begin_step()
        seq = axis_size("seq")
        # ``norm`` makes a microbatch's CE sum its share of the batch's
        # mean. Packed: divided by the global batch's valid-target count
        # (summed over 'data' alone: every rank of a 'seq' group holds the
        # whole rows) and multiplied by the 'data' ranks, which the
        # reduction divides out. Unpacked: divided by the microbatch rows'
        # T - 1 targets (a 'seq' rank sums over its own) and by accum. An
        # MoE term weighs ``targets / S`` in the metric's loss sum.
        row_targets = (n // accum) * (tokens.shape[1] - 1)
        if packed:
            total = all_reduce(_packed_target_weights(labels).sum(),
                               axis_group("data"))
            scale = axis_size("data") / total.clamp_min(1.0)
            targets = total / (accum * axis_size("data"))

            def norm(ce_sum):
                return ce_sum * scale
        else:
            targets = row_targets

            def norm(ce_sum):
                return ce_sum / row_targets / accum
        moe = getattr(model, "moe_experts", 0) > 0
        loss_sum = correct = count = 0
        for i in range(accum):
            x = tokens[i::accum]
            segs = labels[i::accum] if packed else None
            if pp is None:
                out = model(x, segment_ids=segs, train=True,
                            generator=generator,
                            **({"return_hidden": True} if sharded_ce else {}))
                ce_sum, hits, cnt = _lm_microbatch_loss(model, out, x, segs,
                                                        smoothing, sharded_ce)
                aux = _aux_term(model, aux_weight)
                (norm(ce_sum) + aux / (accum * seq)).backward()
                loss_sum = loss_sum + (ce_sum + aux * targets / seq).detach()
                correct, count = correct + hits, count + cnt
                continue
            xs, ss = split_micro(x, pp.M), split_micro(segs, pp.M)

            def loss_fn(m, out):
                nonlocal loss_sum, correct, count
                ce_sum, hits, cnt = _lm_microbatch_loss(
                    model, out, xs[m], ss[m], smoothing, sharded_ce)
                loss_sum = loss_sum + ce_sum.detach()
                correct, count = correct + hits, count + cnt
                return norm(ce_sum)

            model.pipe_train(x, segs, generator, loss_fn,
                             aux_weight / (pp.M * seq * accum) if moe else 0.0,
                             return_hidden=sharded_ce)
            aux = model.moe_aux_loss()
            if aux is not None and aux_weight > 0:
                # This stage's share: its terms summed over the pipeline's
                # M pieces, each weighed as one unpipelined microbatch's.
                loss_sum = loss_sum + aux_weight * aux * targets / (pp.M * seq)
        state.reduce_gradients()
    state.apply_gradients()
    if pp is not None:
        return _pipe_metrics(loss_sum, correct, count, tokens.device)
    return M.from_batch(loss_sum, correct, count, tokens.device)


def make_lm_train_step(optim_cfg: OptimConfig, packed: bool = False,
                       sharded_ce: bool = False,
                       aux_weight: float = 0.0) -> Callable:
    """train_step(state, tokens [B,T] int, labels, generator) -> metrics
    for the LM: ``labels`` are [B, T] segment ids when ``packed``, else
    unread; ``sharded_ce``: the vocab-parallel CE; ``aux_weight`` weighs
    an MoE model's load-balance terms."""

    def train_step(state: TrainState, tokens: torch.Tensor,
                   labels: torch.Tensor, generator: torch.Generator
                   ) -> M.Metrics:
        return fit_lm_batch(state, tokens, labels, generator, optim_cfg,
                            packed, sharded_ce, aux_weight)

    return train_step


def make_lm_eval_step(packed: bool = False,
                      sharded_ce: bool = False) -> Callable:
    """eval_step(model, tokens, labels, mask) -> metrics of next-token
    prediction; ``mask`` [B] zeroes padded rows, and ``packed`` composes
    it with the per-token packing weights of the segment ids in
    ``labels``."""

    def eval_step(model: torch.nn.Module, tokens: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor) -> M.Metrics:
        with torch.no_grad(), span("tpunet_eval_forward"):
            losses, hit = _next_token(model, tokens,
                                      labels if packed else None, 0.0,
                                      sharded_ce)
            wt = mask[:, None]
            if packed:
                wt = wt * _packed_target_weights(labels)[
                    :, _targets(model, tokens.shape[1])]
            count = wt.sum() if packed else wt.sum() * losses.shape[1]
            return M.from_batch((losses * wt).sum(), (hit * wt).sum(), count)

    return eval_step


def make_eval_step(data_cfg: DataConfig) -> Callable:
    """eval_step(model, images_u8, labels, mask) -> metrics; ``mask``
    zeroes padded examples so the test set is counted exactly."""
    preprocess = make_eval_preprocess(data_cfg)

    def eval_step(model: torch.nn.Module, images_u8: torch.Tensor,
                  labels: torch.Tensor, mask: torch.Tensor) -> M.Metrics:
        with torch.no_grad(), span("tpunet_eval_forward"):
            logits = model(preprocess(images_u8).permute(0, 3, 1, 2))
            losses = F.cross_entropy(logits, labels, reduction="none")
            correct = (logits.argmax(-1) == labels).float()
            return M.from_batch((losses * mask).sum(),
                                (correct * mask).sum(), mask.sum())

    return eval_step
