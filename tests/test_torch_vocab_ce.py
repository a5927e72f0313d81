"""The port's vocab-parallel cross-entropy (``tpunet_torch.ops.vocab_ce``)
against tpunet's (``tpunet/ops/vocab_ce.py``) and the full-logits CE.

- On 2 gloo ranks of a 'model' group (``tests/_torch_shard_worker.py
  ... vocab``), the inputs of tests/test_vocab_ce.py's ``_case`` (B 4,
  T 9, C 16, V 64, numpy seed 0), with smoothing 0 and 0.1: the CE
  against tpunet's ``vocab_parallel_ce`` on its dp2 x vp4 CPU mesh and
  against the full-logits CE (optax) within rtol/atol 1e-6, the hits
  equal, and the gradients of the CE's mean with respect to h and the
  table within rtol 1e-5 / atol 1e-7, on every rank: test_vocab_ce.py's
  tolerances.
- ``resolve_vocab_ce`` resolves as tpunet's, and ``full_ce`` is the
  full-logits CE of tpunet's steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpunet.config import MeshConfig as JaxMeshConfig
from tpunet.ops.vocab_ce import resolve_vocab_ce as jax_resolve
from tpunet.ops.vocab_ce import vocab_parallel_ce as jax_vocab_ce
from tpunet.parallel import make_mesh
from tpunet_torch.ops.vocab_ce import full_ce, resolve_vocab_ce, vocab_parallel_ce

import _torch_gang
import _torch_threads  # noqa: F401

WORLD = 2


def _case(B=4, T=9, C=16, V=64, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, T, C)).astype(np.float32)
    emb = rng.normal(size=(V, C)).astype(np.float32)
    tgt = rng.integers(0, V, (B, T)).astype(np.int32)
    return h, emb, tgt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 2-rank gang's results, rank by rank."""
    d = tmp_path_factory.mktemp("vocab_ce")
    h, emb, tgt = _case()
    np.savez(d / "vocab.npz", h=h, emb=emb, tgt=tgt)
    procs = _torch_gang.start(d, WORLD, ["vocab"])
    _torch_gang.wait(d, WORLD, procs)
    return [torch.load(d / f"vocab_rank{r}.pt") for r in range(WORLD)]


@functools.lru_cache(maxsize=None)
def _tpunet(smoothing):
    """tpunet's sharded CE, hits and (dh, demb), and the full-logits CE
    and its gradients (optax), on the same inputs."""
    h, emb, tgt = (jnp.asarray(a) for a in _case())
    mesh = make_mesh(JaxMeshConfig(data=2, model=4))

    def full(h, emb):
        lg = jnp.einsum("btc,vc->btv", h, emb)
        if smoothing > 0:
            return optax.softmax_cross_entropy(lg, optax.smooth_labels(
                jax.nn.one_hot(tgt, lg.shape[-1]), smoothing))
        return optax.softmax_cross_entropy_with_integer_labels(lg, tgt)

    def sharded(h, emb):
        with mesh:
            return jax_vocab_ce(h, emb, tgt, mesh, smoothing=smoothing)

    ce_s, hit_s = sharded(h, emb)
    g_s = jax.grad(lambda h, e: sharded(h, e)[0].mean(), (0, 1))(h, emb)
    g_f = jax.grad(lambda h, e: full(h, e).mean(), (0, 1))(h, emb)
    return (np.asarray(ce_s), np.asarray(hit_s), [np.asarray(g) for g in g_s],
            np.asarray(full(h, emb)), [np.asarray(g) for g in g_f])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_two_ranks_match_tpunet_and_the_full_logits(ranks, smoothing):
    ce_s, hit_s, g_s, ce_f, g_f = _tpunet(smoothing)
    for got in ranks:
        got = got[smoothing]
        for want in (ce_s, ce_f):
            np.testing.assert_allclose(got["ce"].numpy(), want,
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["hit"].numpy(), hit_s)
        for want in (g_s, g_f):
            np.testing.assert_allclose(got["dh"].numpy(), want[0],
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got["demb"].numpy(), want[1],
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_one_rank_and_full_ce_match_tpunet(smoothing):
    """Without a group the factorization runs over the whole vocab; the
    full-logits CE beside it is tpunet's optax CE."""
    ce_s, hit_s, g_s, ce_f, _ = _tpunet(smoothing)
    h, emb, tgt = (torch.from_numpy(a) for a in _case())
    h.requires_grad_()
    ce, hit = vocab_parallel_ce(h, emb, tgt, None, smoothing=smoothing)
    np.testing.assert_allclose(ce.detach().numpy(), ce_s, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(hit.numpy(), hit_s)
    ce.mean().backward()
    np.testing.assert_allclose(h.grad.numpy(), g_s[0], rtol=1e-5, atol=1e-7)
    ce2, hit2 = full_ce(h.detach(), emb, tgt, smoothing=smoothing)
    np.testing.assert_allclose(ce2.numpy(), ce_f, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(hit2.numpy(), hit_s)


def test_resolve_vocab_ce_as_tpunet():
    mesh = make_mesh(JaxMeshConfig(data=2, model=4))
    mesh1 = make_mesh(JaxMeshConfig(data=8))
    for setting, vp, vocab in (("auto", 4, 64), ("auto", 4, 63),
                               ("auto", 1, 64), ("full", 4, 64),
                               ("sharded", 4, 64)):
        m = mesh if vp > 1 else mesh1
        assert resolve_vocab_ce(setting, vp, vocab) == \
            jax_resolve(setting, m, vocab)
    for setting, vp, vocab, match in (("sharded", 4, 63, "divides"),
                                      ("sharded", 1, 64, "divides"),
                                      ("nope", 4, 64, "unknown")):
        with pytest.raises(ValueError, match=match):
            resolve_vocab_ce(setting, vp, vocab)
