"""Parity of the port's plain attentions with tpunet's, on the CPU.

``dense_attention`` and ``blockwise_attention`` of
``tpunet_torch.ops.attention`` against ``tpunet.ops.attention`` on the
same float32 inputs (made with numpy): non-causal, causal with tq = tk
and tq < tk (the ``tk - tq`` offset), and packed segments with a query
whose segment has no key (its row must be 0). Tolerance 1e-5: the same
float32 arithmetic, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.ops import attention as jatt
from tpunet_torch.ops import attention as att
import _torch_threads  # noqa: E402,F401

# (b, tq, tk, h, d, causal, segments)
CASES = [(2, 24, 24, 2, 8, False, False), (2, 24, 24, 2, 8, True, False),
         (1, 12, 40, 3, 16, True, False), (2, 32, 32, 2, 8, False, True),
         (2, 32, 32, 2, 8, True, True)]
IDS = ["plain", "causal", "causal_tq_lt_tk", "segments", "causal_segments"]


def _inputs(case, seed=0):
    b, tq, tk, h, d, causal, segmented = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, h, d)).astype(np.float32)
    seg = None
    if segmented:
        qs = np.sort(rng.integers(1, 4, (b, tq)), axis=1).astype(np.int32)
        ks = np.sort(rng.integers(1, 4, (b, tk)), axis=1).astype(np.int32)
        qs[:, 0] = 9                         # no key of segment 9
        seg = (qs, ks)
    return q, k, v, seg, causal


def _jax(seg):
    return None if seg is None else tuple(jnp.asarray(s) for s in seg)


def _torch(seg):
    return None if seg is None else tuple(torch.from_numpy(s) for s in seg)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dense_attention_matches_tpunet(case):
    q, k, v, seg, causal = _inputs(case)
    want = np.asarray(jatt.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=_jax(seg)))
    got = att.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              segment_ids=_torch(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if seg is not None:
        assert np.all(got[:, 0] == 0)        # the orphan query's row


@pytest.mark.parametrize("block", [4, 8])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_blockwise_attention_matches_tpunet(case, block):
    q, k, v, seg, causal = _inputs(case, seed=1)
    want = np.asarray(jatt.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_size=block,
        causal=causal, segment_ids=_jax(seg)))
    got = att.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), block_size=block,
                                  causal=causal,
                                  segment_ids=_torch(seg)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_scores_are_float32_products():
    """bf16 operands: float32 scores and accumulation (tpunet's
    preferred_element_type), output in bf16."""
    q, k, v, _, _ = _inputs(CASES[0], seed=2)
    want = np.asarray(jatt.dense_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16)).astype(jnp.float32))
    got = att.dense_attention(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=2**-7)


def test_blockwise_needs_a_dividing_block_and_divisor_block_finds_one():
    q, k, v, _, _ = _inputs(CASES[0])
    with pytest.raises(ValueError, match="not divisible"):
        att.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                block_size=5)
    for t, cap in [(196, 512), (196, 64), (97, 16), (24, 8), (1, 4)]:
        assert att._divisor_block(t, cap) == jatt._divisor_block(t, cap)


@pytest.mark.parametrize("name", ["ring_attention", "ring_self_attention",
                                  "ulysses_attention",
                                  "ulysses_self_attention"])
def test_sequence_parallel_attentions_raise_with_their_item(name):
    """Refused until ROADMAP Queue A item 8b ported them: each
    sequence-parallel attention now computes. In one process its 'seq'
    axis has one rank, and it is tpunet's dense attention (the blockwise
    core takes head dim 8; tests/test_torch_seq.py holds both cores on
    gloo gangs against tpunet's ring and Ulysses)."""
    q, k, v, _, causal = _inputs(CASES[1])
    want = np.asarray(jatt.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = getattr(att, name)(*(torch.from_numpy(a) for a in (q, k, v)),
                             causal=causal, core="blockwise")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
