"""Parity of the serving engine's attention hooks (``tpunet_torch.models.
vit``: per-row ``decode_attend`` and ``paged_decode_attend``, reached
through the LM's per-row ``pos_offset``/``decode_active``/``paged_kv``
forward) with tpunet's ``Attention._decode_attend`` and
``_paged_decode_attend`` through ``model.apply``, on the CPU.

tests/test_serve.py's TINY LM (hidden 32, depth 2, 2 heads, vocab 31,
max_seq_len 48, float32) with tpunet's init redrawn from numpy
(``_torch_port.lm_params``). Both packages start from the same cache,
drawn at random so that every row has content to keep; three rows at
staggered positions, one inactive, T = 1 (a decode step) and T = 8 (a
bucketed chunked prefill), dense pools and pages of the compute dtype
or bf16. Logits within 1e-5, the written cache within 1e-5 (bf16 pages:
one bf16 ulp), and an inactive row's cache (dense rows, or its pages)
unchanged to the bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpunet.models.vit import PagedKV as JaxPagedKV
from tpunet_torch.models.vit import KVCache, PagedKV

from _torch_port import jax_lm, lm_params, port_lm
import _torch_threads  # noqa: E402,F401

TINY = dict(vocab_size=31, max_seq_len=48)
H, D, DEPTH, TOTAL = 2, 16, 2, 48
PT = 4                       # tokens a page
SLOTS_PER_ROW = TOTAL // PT  # page-table width


@pytest.fixture(scope="module")
def models():
    params = lm_params(0, **TINY)
    return params, jax_lm(**TINY), port_lm(params, "dense", **TINY)


def _rows(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (b, t)).astype(np.int32)


def _jax_cache(cache_k, cache_v, paged):
    """tpunet's cache collection holding the per-layer arrays."""
    out = {}
    for i in range(DEPTH):
        layer = {"cached_k": jnp.asarray(cache_k[i]),
                 "cached_v": jnp.asarray(cache_v[i])}
        if not paged:
            layer["cache_index"] = jnp.zeros((), jnp.int32)
        out[f"block{i:02d}"] = {"attn": layer}
    return out


def _run(models, tokens, positions, active, cache_k, cache_v,
         paged_kv=None, table=None, jax_paged=None):
    """Both packages' step from the same cache (float32 numpy, or bf16
    values held in float32 for bf16 pages); returns the logits and the
    caches after it, as float32 numpy."""
    params, jm, pm = models
    kw = {}
    store = jnp.float32
    if paged_kv is not None:
        kw = dict(paged_kv=jax_paged, page_table=jnp.asarray(table))
        store = jax_paged.store_dtype(jnp.float32)
    want, mut = jm.apply(
        {"params": params, "cache": _jax_cache(
            [c.astype(store) for c in cache_k],
            [c.astype(store) for c in cache_v], paged_kv is not None)},
        jnp.asarray(tokens), train=False, decode=True,
        pos_offset=jnp.asarray(positions, jnp.int32),
        decode_active=jnp.asarray(active), mutable=["cache"], **kw)
    dtype = (paged_kv.store_dtype(torch.float32) if paged_kv is not None
             else torch.float32)
    cache = KVCache(tuple(torch.from_numpy(c.copy()).to(dtype)
                          for c in cache_k),
                    tuple(torch.from_numpy(c.copy()).to(dtype)
                          for c in cache_v))
    pkw = {}
    if paged_kv is not None:
        pkw = dict(paged_kv=paged_kv, page_table=torch.from_numpy(table))
    with torch.inference_mode():
        got, out = pm(torch.from_numpy(tokens),
                      pos_offset=torch.tensor(positions),
                      cache=cache, decode_active=torch.tensor(active),
                      **pkw)
    jk, jv = ([np.asarray(mut["cache"][f"block{i:02d}"]["attn"][name],
                          np.float32) for i in range(DEPTH)]
              for name in ("cached_k", "cached_v"))
    assert out is cache                 # the engine owns the clock
    return (np.asarray(want), got.numpy(), jk, jv,
            [t.float().numpy() for t in cache.k],
            [t.float().numpy() for t in cache.v])


CASES = {
    # (T, positions): row 1 inactive throughout.
    "decode": (1, [0, 17, 40]),
    "prefill": (8, [0, 9, 24]),
    # Row 2's chunk runs past the cache end: XLA clamps the write's start
    # to 40 (the engine never asks for it), the port reproduces it.
    "prefill_clamped": (8, [3, 13, 44]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_attend_matches_tpunet(models, case):
    t, positions = CASES[case]
    rng = np.random.default_rng(1)
    ck = [rng.normal(size=(3, TOTAL, H, D)).astype(np.float32)
          for _ in range(DEPTH)]
    cv = [rng.normal(size=(3, TOTAL, H, D)).astype(np.float32)
          for _ in range(DEPTH)]
    active = [True, False, True]
    want, got, jk, jv, pk, pv = _run(models, _rows(3, t, 2), positions,
                                     active, ck, cv)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for i in range(DEPTH):
        np.testing.assert_allclose(pk[i], jk[i], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pv[i], jv[i], rtol=1e-5, atol=1e-5)
        # the inactive row is bit-frozen, the active ones were written
        np.testing.assert_array_equal(pk[i][1], ck[i][1])
        np.testing.assert_array_equal(pv[i][1], cv[i][1])
        assert not np.array_equal(pk[i][0], ck[i][0])


def _page_table(seed, pages, lengths):
    """Distinct pages (1..pages-1, page 0 the garbage page) covering
    each row's first ``lengths[b]`` positions; 0 beyond."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, pages))
    table = np.zeros((len(lengths), SLOTS_PER_ROW), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        k = -(-n // PT)
        table[b, :k] = perm[used:used + k]
        used += k
    return table


@pytest.mark.parametrize("kv_dtype", ["auto", "bf16"])
@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_paged_attend_matches_tpunet(models, case, kv_dtype):
    t, positions = CASES[case]
    pages = 40
    table = _page_table(3, pages, [p + t for p in positions])
    rng = np.random.default_rng(4)
    ck, cv = ([rng.normal(size=(pages * PT, H, D)).astype(np.float32)
               for _ in range(DEPTH)] for _ in range(2))
    if kv_dtype == "bf16":      # bf16 pages: the same bf16 values both sides
        ck, cv = ([np.asarray(jnp.asarray(c, jnp.bfloat16), np.float32)
                   for c in cs] for cs in (ck, cv))
    active = [True, False, True]
    jax_paged = JaxPagedKV(pages=pages, page_tokens=PT,
                           dtype="bfloat16" if kv_dtype == "bf16" else "auto")
    paged = PagedKV(pages=pages, page_tokens=PT, dtype=kv_dtype)
    want, got, jk, jv, pk, pv = _run(models, _rows(3, t, 5), positions,
                                     active, ck, cv, paged, table,
                                     jax_paged)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Written rows: in bf16 the same float32 K/V rounded on both sides, so
    # at most one bf16 ulp apart. Page 0 takes the inactive row's
    # (duplicate) writes in any order.
    tol = 2.0**-7 if kv_dtype == "bf16" else 1e-5
    frozen = np.concatenate([np.arange(p * PT, (p + 1) * PT)
                             for p in table[1] if p])
    for i in range(DEPTH):
        np.testing.assert_allclose(pk[i][PT:], jk[i][PT:], rtol=tol,
                                   atol=1e-5)
        np.testing.assert_allclose(pv[i][PT:], jv[i][PT:], rtol=tol,
                                   atol=1e-5)
        np.testing.assert_array_equal(pk[i][frozen], ck[i][frozen])
        np.testing.assert_array_equal(pv[i][frozen], cv[i][frozen])


def test_paged_and_dense_agree_and_module_clock_is_unchanged(models):
    """The same rows through a dense cache and through pages give the
    same logits; and per-row calls leave ``generate``'s module-clock
    step as it was (an int position advances the cache's index)."""
    _, _, pm = models
    toks = torch.from_numpy(_rows(2, 8, 6))
    dense = pm.init_cache(2, TOTAL)
    paged_kv = PagedKV(pages=1 + 2 * SLOTS_PER_ROW, page_tokens=PT)
    pool = pm.init_paged_cache(paged_kv)
    table = torch.arange(1, 1 + 2 * SLOTS_PER_ROW,
                         dtype=torch.int32).view(2, SLOTS_PER_ROW)
    pos = torch.tensor([0, 5])
    with torch.inference_mode():
        a, _ = pm(toks, pos_offset=pos, cache=dense)
        b, _ = pm(toks, pos_offset=pos, cache=pool, paged_kv=paged_kv,
                  page_table=table)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        cache = pm.init_cache(2, TOTAL)
        _, cache = pm(toks[:, :1], pos_offset=0, cache=cache)
        assert cache.index == 1
    # int8 pages are ported (tests/test_torch_serve_int8.py holds them to
    # tpunet's): int8 codes with a float32 scale a flat row, per layer.
    int8 = PagedKV(pages=3, page_tokens=PT, dtype="int8")
    assert int8.quantized and int8.store_dtype(torch.float32) == torch.int8
    pool = pm.init_paged_cache(int8)
    assert [t.dtype for t in pool.leaves()] == \
        [torch.int8] * 2 * DEPTH + [torch.float32] * 2 * DEPTH
    assert pool.sk[0].shape == (3 * PT,)
    with pytest.raises(ValueError, match="unknown kv dtype"):
        PagedKV(pages=3, page_tokens=PT, dtype="int4")
