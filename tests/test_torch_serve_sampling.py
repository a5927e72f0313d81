"""The serving engine's samplers against tpunet's, on the CPU.

``tpunet_torch.serve.sampling.batched_sample`` (the device sampler):
greedy rows are the bitwise argmax of the raw logits (ties to the first
index, as ``np.argmax``); each sampled row's support is exactly
tpunet's ``filter_logits`` support (top-k, then the nucleus of the
renormalised rest) at per-row parameters; a draw depends on (seed, step)
only, not on the row's slot or its batch partners; and the draws follow
the filtered softmax. ``sample_token`` (the host sampler, numpy) draws
the same tokens as tpunet's on the same logits and seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpunet.models.lm import filter_logits as jax_filter_logits
from tpunet.serve import GenerateRequest as JaxRequest
from tpunet.serve import sample_token as jax_sample_token
from tpunet_torch.serve import GenerateRequest, sample_token
from tpunet_torch.serve.sampling import (batched_sample, filter_rows,
                                        gumbel_noise)

V = 31


def _params(b, temperature=0.8, top_k=0, top_p=0.0, seed=0, step=0):
    full = lambda x, dt: torch.full((b,), x, dtype=dt)  # noqa: E731
    return (full(temperature, torch.float32), full(top_k, torch.int64),
            full(top_p, torch.float32), full(seed, torch.int64),
            full(step, torch.int64))


def test_greedy_rows_are_the_bitwise_argmax():
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(6, V)).astype(np.float32)
    lg[1, [3, 9]] = lg[1].max() + 1.0          # a tie: the first index
    lg[4] = 0.0                                # all equal
    temp, top_k, top_p, seeds, steps = _params(6, temperature=0.0)
    temp[5] = 0.9                              # a sampled partner row
    got = batched_sample(torch.from_numpy(lg), temp, top_k, top_p, seeds,
                         steps).numpy()
    np.testing.assert_array_equal(got[:5], np.argmax(lg[:5], axis=-1))
    assert got[1] == 3 and got[4] == 0


@pytest.mark.parametrize("top_k,top_p", [(3, 0.0), (0, 0.7), (5, 0.8),
                                         (0, 0.0), (V, 0.999), (1, 0.5)])
def test_support_equals_filter_logits(top_k, top_p):
    """Per-row parameters: every row here uses (top_k, top_p) at its own
    temperature, next to partners with other filters."""
    rng = np.random.default_rng(3)
    lg = (rng.normal(size=(8, V)) * 2).astype(np.float32)
    lg[2, :4] = lg[2].max()                    # ties at the k-th value
    temps = np.linspace(0.5, 1.5, 8).astype(np.float32)
    tk = np.where(np.arange(8) % 2, top_k, 2).astype(np.int64)
    tp = np.where(np.arange(8) % 2, top_p, 0.9).astype(np.float32)
    got = filter_rows(torch.from_numpy(lg), torch.from_numpy(temps),
                      torch.from_numpy(tk), torch.from_numpy(tp)).numpy()
    for r in range(8):
        want = np.asarray(jax_filter_logits(
            jnp.asarray(lg[r:r + 1]) / temps[r], top_k=int(tk[r]),
            top_p=float(tp[r])))[0]
        np.testing.assert_array_equal(np.isfinite(got[r]),
                                      np.isfinite(want))
        # the draws land in the support
        draws = batched_sample(
            torch.from_numpy(np.repeat(lg[r:r + 1], 64, 0)),
            torch.full((64,), float(temps[r])), torch.full((64,), int(tk[r])),
            torch.full((64,), float(tp[r])), torch.full((64,), 5),
            torch.arange(64)).numpy()
        assert np.isfinite(want[draws]).all()


def test_draw_depends_on_seed_and_step_only():
    """The same (seed, step) gives the same token at any slot and with
    any batch partners; other steps and seeds move it."""
    rng = np.random.default_rng(5)
    row = (rng.normal(size=V) * 0.5).astype(np.float32)
    seen = []
    for trial in range(6):
        b = 3 + trial
        lg = (rng.normal(size=(b, V)) * 3).astype(np.float32)
        slot = trial % b
        lg[slot] = row
        temp, top_k, top_p, seeds, steps = _params(b, 1.0, 0, 0.0)
        temp[:] = torch.from_numpy(rng.uniform(0.0, 2.0, b).astype(np.float32))
        seeds[:] = torch.from_numpy(rng.integers(0, 2**31, b))
        steps[:] = torch.from_numpy(rng.integers(0, 500, b))
        temp[slot], seeds[slot], steps[slot] = 1.0, 1234, 17
        seen.append(int(batched_sample(torch.from_numpy(lg), temp, top_k,
                                       top_p, seeds, steps)[slot]))
    assert len(set(seen)) == 1
    flat = torch.from_numpy(np.tile(row, (64, 1)))
    by_step = batched_sample(flat, *_params(64, 1.0, seed=1234)[:3],
                             torch.full((64,), 1234), torch.arange(64))
    by_seed = batched_sample(flat, *_params(64, 1.0)[:3],
                             torch.arange(64), torch.full((64,), 17))
    assert len(set(by_step.tolist())) > 5 and len(set(by_seed.tolist())) > 5
    assert int(by_step[17]) == seen[0]


def test_draws_follow_the_filtered_softmax():
    """20,000 draws of one row (one seed, steps 0..19,999) against
    softmax(filtered logits / T): every frequency within 4.5 standard
    errors."""
    lg = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -3.0] + [-9.0] * (V - 6)])
    n = 20000
    temp, top_k, top_p, seeds, _ = _params(n, 0.8, top_k=5)
    draws = batched_sample(lg.expand(n, V), temp, top_k, top_p, seeds,
                           torch.arange(n))
    p = torch.softmax(filter_rows(lg, temp[:1], top_k[:1], top_p[:1]),
                      -1)[0].double().numpy()
    freq = np.bincount(draws.numpy(), minlength=V) / n
    se = np.sqrt(p * (1 - p) / n)
    assert freq[5:].sum() == 0
    assert np.all(np.abs(freq - p) <= 4.5 * se + 1e-12)


def test_gumbel_noise_is_finite_and_standard():
    g = gumbel_noise(torch.tensor([0, 2**31 - 1]), torch.tensor([0, 7]),
                     4096)
    assert torch.isfinite(g).all()
    # standard Gumbel: mean 0.5772, variance pi^2 / 6
    assert abs(g.mean().item() - 0.5772) < 0.05
    assert abs(g.var().item() - np.pi**2 / 6) < 0.15


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 0.0), (0.8, 0, 0.0), (1.0, 5, 0.0), (0.7, 0, 0.8),
    (1.3, 8, 0.9)])
def test_sample_token_matches_tpunet(temperature, top_k, top_p):
    """The host sampler is a copy: on the same logits and seed the same
    draws, call after call (each request's own numpy generator)."""
    rng = np.random.default_rng(7)
    kw = dict(max_new_tokens=1, temperature=temperature, top_k=top_k,
              top_p=top_p, seed=11)
    port, ref = GenerateRequest([1], **kw), JaxRequest([1], **kw)
    for _ in range(20):
        lg = (rng.normal(size=V) * 2).astype(np.float32)
        assert sample_token(lg, port) == jax_sample_token(lg, ref)
