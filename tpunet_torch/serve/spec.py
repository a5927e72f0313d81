"""Speculative decoding support, port of ``tpunet/serve/spec.py``:
drafter construction, acceptance, the drafter's checkpoint and its fit.

Draft-then-verify decoding: a narrow drafter proposes ``K`` tokens per
active slot against its own paged KV pool, the serving model scores all
``K+1`` positions in ONE batched forward over the main pool, and the
engine (``tpunet_torch/serve/engine.py``) keeps the longest verified
prefix. This module owns everything that is NOT engine plumbing:

- ``drafter_model_config``: the width_mult lever applied to the serving
  ``ModelConfig`` (vit_hidden scaled, kept divisible by vit_heads so
  head_dim stays integral).
- ``accept_drafts``: the pure acceptance rule. Verify consumes
  ``[next_token, d_1..d_K]`` and produces choices ``c_0..c_K`` where
  ``c_j`` is the model's (sampled or greedy) token AFTER position
  ``pos+j``. The accepted count ``a`` is the longest prefix with
  ``d_j == c_{j-1}``; the engine emits ``c_0..c_a`` — every emitted
  token comes from the VERIFY distribution, so the output stream is the
  non-speculative stream at ANY acceptance rate (greedy and per-(seed,
  step) sampled alike).
- ``save_drafter_params`` / ``load_drafter_params``: the drafter's
  checkpoint (``--spec-draft-checkpoint``) in tpunet's flat-npz layout
  (``/``-joined Flax paths), through ``models.convert``'s LM bridge, so
  a drafter fitted by either package loads in both.
- ``fit_drafter``: deterministic distillation of a drafter onto the
  serving model's own greedy trajectories (hard-target cross-entropy,
  tpunet's hand-rolled Adam). You fit the drafter to the traffic you
  serve, as an operator distills against logged traffic.

Everything here is deterministic — same inputs, same drafter, same
acceptance — because failover resume and bitwise replay depend on it.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from tpunet_torch.config import ModelConfig
from tpunet_torch.models.convert import lm_params_to_jax, lm_state_dict_from_jax

__all__ = [
    "drafter_model_config",
    "accept_drafts",
    "save_drafter_params",
    "load_drafter_params",
    "fit_drafter",
]


def drafter_model_config(cfg: ModelConfig,
                         width_mult: float) -> ModelConfig:
    """The drafter's ModelConfig: ``vit_hidden`` scaled by ``width_mult``
    and rounded DOWN to the nearest multiple of ``vit_heads`` (floor one
    full head) so attention head_dim stays integral. Depth, vocab, and
    max_seq_len are preserved — the drafter must cover the same positions
    the serving model does."""
    if width_mult <= 0:
        raise ValueError(f"spec_draft_width_mult must be > 0, "
                         f"got {width_mult}")
    heads = cfg.vit_heads
    hidden = int(cfg.vit_hidden * width_mult) // heads * heads
    hidden = max(heads, hidden)
    return dataclasses.replace(cfg, vit_hidden=hidden)


def accept_drafts(drafts: np.ndarray, choices: np.ndarray) -> np.ndarray:
    """Accepted-token counts per row.

    ``drafts``: ``[B, K]`` drafter proposals ``d_1..d_K``.
    ``choices``: ``[B, K+1]`` verify outputs ``c_0..c_K`` (the model's
    token after each of positions ``pos..pos+K``).

    Returns ``a`` ``[B]`` with ``0 <= a[i] <= K``: the longest prefix
    where ``d_j == c_{j-1}``. The engine then emits ``c_0..c_a`` —
    ``a+1`` tokens, all from the verify pass. ``c_a`` doubles as the next
    cycle's input token (the "bonus" token on full acceptance).
    """
    drafts = np.asarray(drafts)
    choices = np.asarray(choices)
    if drafts.ndim != 2 or choices.ndim != 2 \
            or choices.shape != (drafts.shape[0], drafts.shape[1] + 1):
        raise ValueError(
            f"shape mismatch: drafts {drafts.shape} vs choices "
            f"{choices.shape} (want [B, K] and [B, K+1])")
    match = drafts == choices[:, :-1]
    # First mismatch position == accepted count; all-match rows accept
    # the full K (argmin on an all-True row returns 0, so patch them).
    a = np.argmin(match, axis=1)
    a[match.all(axis=1)] = drafts.shape[1]
    return a.astype(np.int64)


def _flatten(params, prefix=""):
    out = {}
    for key in sorted(params):
        val = params[key]
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def save_drafter_params(path: str,
                        state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a drafter's state dict (the port's LM layout) as tpunet's
    flat ``.npz``: keys are the ``/``-joined paths of the Flax tree
    (``models.convert.lm_params_to_jax``). Torn-write-safe via tmp +
    rename."""
    flat = _flatten(lm_params_to_jax(state_dict))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_drafter_params(path: str, like) -> Dict[str, torch.Tensor]:
    """Load a tpunet-layout drafter npz (``save_drafter_params`` of either
    package) as a state dict for ``like``, the drafter model (a
    ``TransformerLM`` of the drafter's width). Every leaf must be present
    with the template's exact shape — a drafter checkpoint from a
    different width/depth is a config error, not something to silently
    pad."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    template = _flatten(lm_params_to_jax(like.state_dict()))
    missing = sorted(set(template) - set(flat))
    extra = sorted(set(flat) - set(template))
    if missing or extra:
        raise ValueError(
            f"drafter checkpoint {path!r} does not match the drafter "
            f"architecture: missing={missing[:4]} extra={extra[:4]}")
    for k, tmpl in template.items():
        if flat[k].shape != tmpl.shape:
            raise ValueError(
                f"drafter checkpoint {path!r} leaf {k!r} has shape "
                f"{flat[k].shape}, drafter wants {tmpl.shape}")
    return lm_state_dict_from_jax(_unflatten(flat))


def fit_drafter(model, drafter_model, prompts, *, gen_tokens: int = 64,
                steps: int = 300, lr: float = 3e-3,
                log: Optional[Callable[[str], None]] = None
                ) -> Dict[str, torch.Tensor]:
    """Distill ``drafter_model`` onto ``model``'s greedy trajectories
    (both ``TransformerLM``s on one device).

    ``prompts`` is ``[N, P]`` int — the traffic to fit against. The
    teacher generates ``gen_tokens`` greedy continuations (dense
    full-prefix forwards; O(L^2) but the fitting set is small), then the
    drafter minimizes hard-target cross-entropy on the generated region
    with tpunet's hand-rolled Adam (beta 0.9/0.999, eps 1e-8, bias
    correction, float32). No draw is random: the same teacher, prompts
    and init give the same drafter, which keeps spec-on serving
    replayable. ``drafter_model``'s parameters are trained in place;
    returns a copy of its state dict (the engine's ``drafter_params``).
    """
    device = model.pos_embed.device
    prompts = torch.as_tensor(np.asarray(prompts, np.int64), device=device)
    n, plen = prompts.shape
    total = plen + gen_tokens
    if total > drafter_model.max_len:
        raise ValueError(
            f"fit window {total} exceeds drafter max_len "
            f"{drafter_model.max_len}")
    toks = torch.zeros((n, total), dtype=torch.long, device=device)
    toks[:, :plen] = prompts
    with torch.no_grad():
        for i in range(plen, total):
            lg = model(toks[:, :i])
            toks[:, i] = lg[:, -1].float().argmax(-1)
    tgt = toks[:, 1:]
    mask = (torch.arange(total - 1, device=device)[None, :]
            >= plen - 1).float()

    def loss_fn():
        # train=True only so the float32 parameters' casts are made under
        # autograd; the drafter has no dropout, so the math is eval's.
        lg = drafter_model(toks[:, :-1], train=True)
        logp = torch.log_softmax(lg.float(), -1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        return (nll * mask).sum() / mask.sum() / n

    params = list(drafter_model.parameters())
    mom = [torch.zeros_like(p) for p in params]
    vel = [torch.zeros_like(p) for p in params]
    b1 = torch.tensor(0.9, dtype=torch.float32)
    b2 = torch.tensor(0.999, dtype=torch.float32)
    for t in range(1, steps + 1):
        grads = torch.autograd.grad(loss_fn(), params)
        c1 = (1 - b1 ** t).to(device)
        c2 = (1 - b2 ** t).to(device)
        with torch.no_grad():
            for p, m, v, g in zip(params, mom, vel, grads):
                m.mul_(0.9).add_(0.1 * g)
                v.mul_(0.999).add_(0.001 * g * g)
                p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))
        if log is not None and t % 100 == 0:
            with torch.no_grad():
                log(f"fit_drafter step {t}/{steps}: "
                    f"loss {float(loss_fn()):.4f}")
    return {k: v.detach().clone()
            for k, v in drafter_model.state_dict().items()}
