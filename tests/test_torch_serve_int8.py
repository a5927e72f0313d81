"""The port's int8 KV pages against tpunet's, on the CPU.

``quantize_kv_rows`` against tpunet's ``_quantize_kv_rows`` on seeded
rows with an all-zero row, an outlier row and exact .5 ties (the codes
equal, the scales bit-equal); the int8 paged attend against tpunet's
``Attention`` paged path from the same pool contents (codes and scales),
logits within 1e-5; the int8 engine's greedy tokens against tpunet's
int8 engine's on the 6 prompt seeds of tpunet's eval-parity gate
(tests/test_serve_paged.py, tpunet's own init of its TINY LM). int8 KV
really does change a greedy stream there: on seed 2 both packages'
int8 streams leave the float32 stream at index 2, so the port is held to
tpunet's int8 path, not to float32. Then the page cost and the refusal
of int8 without the paged pool.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import ServeConfig as JaxServeConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.models.vit import PagedKV as JaxPagedKV
from tpunet.models.vit import _quantize_kv_rows
from tpunet.serve import Engine as JaxEngine
from tpunet_torch.config import ServeConfig
from tpunet_torch.models.lm import generate
from tpunet_torch.models.vit import KVCache, PagedKV, quantize_kv_rows
from tpunet_torch.serve import Engine

from _torch_port import jax_lm, lm_params, port_lm

TINY = dict(vocab_size=31, max_seq_len=48)
H, D, DEPTH = 2, 16, 2
PT, PAGES = 4, 40
SLOTS_PER_ROW = TINY["max_seq_len"] // PT
GATE_SEEDS = range(6)


def gate_prompt(seed):
    """tpunet's gate prompt of ``seed`` (its ``prompts(1, rng_seed=seed)``)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"],
                        size=int(rng.integers(2, 9))).astype(np.int32)


@pytest.fixture(scope="module")
def gate_lm():
    """tpunet's TINY LM of its int8 gate with tpunet's own init, and the
    port's LM holding the same weights."""
    model = jax_create_model(JaxModelConfig(
        name="lm", vit_hidden=32, vit_depth=2, vit_heads=2, dropout_rate=0.0,
        dtype="float32", **TINY))
    variables = init_variables(model, jax.random.PRNGKey(0), seq_len=8)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, variables, port_lm(params, "dense", **TINY)


def make_engine(lm, **cfg_kw):
    cfg_kw.setdefault("slots", 4)
    cfg_kw.setdefault("queue_max", 16)
    cfg_kw.setdefault("prefill_buckets", (8, 16))
    cfg_kw.setdefault("default_max_new_tokens", 6)
    cfg_kw.setdefault("emit_every_s", 0.0)
    return Engine(lm, ServeConfig(**cfg_kw))


def test_quantize_kv_rows_equals_tpunet():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, H, D)).astype(np.float32)
    x[3] = 0.0                                  # all-zero row: scale 1
    x[7] *= 1e-3
    x[9, 0, 0] = 300.0                          # outlier row
    # Exact ties: row amax 127 gives scale 1, so each x.5 sits on .5.
    halves = np.arange(-15.5, 15.0, 1.0, dtype=np.float32)
    x[11] = np.concatenate([[127.0], halves]).reshape(H, D)
    want_q, want_s = (np.asarray(a) for a in _quantize_kv_rows(
        jnp.asarray(x)))
    got_q, got_s = quantize_kv_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert got_s[3] == 1.0 and (got_q[3] == 0).all()
    # half to even in both: -15.5 -> -16, ..., 0.5 -> 0, 1.5 -> 2
    np.testing.assert_array_equal(want_q[11].reshape(-1)[1:],
                                  np.round(halves).astype(np.int8))


@pytest.mark.parametrize("t,positions", [(1, [0, 17, 40]), (8, [0, 9, 24])])
def test_int8_paged_attend_matches_tpunet(t, positions):
    """One decode step (T 1) and one chunked prefill (T 8) over an int8
    pool of random codes and scales, three rows, the middle one inactive:
    tpunet's ``model.apply`` and the port's forward from the same pool."""
    params = lm_params(0, **TINY)
    jm, pm = jax_lm(**TINY), port_lm(params, "dense", **TINY)
    rng = np.random.default_rng(4)
    perm = rng.permutation(np.arange(1, PAGES))
    table = np.zeros((3, SLOTS_PER_ROW), np.int32)
    used = 0
    for b, p in enumerate(positions):
        k = -(-(p + t) // PT)
        table[b, :k] = perm[used:used + k]
        used += k
    rows = PAGES * PT
    codes = [rng.integers(-127, 128, size=(rows, H, D)).astype(np.int8)
             for _ in range(2 * DEPTH)]
    scales = [rng.uniform(0.005, 0.02, size=rows).astype(np.float32)
              for _ in range(2 * DEPTH)]
    tokens = rng.integers(0, TINY["vocab_size"], (3, t)).astype(np.int32)
    active = [True, False, True]
    jcache = {f"block{i:02d}": {"attn": {
        "cached_k": jnp.asarray(codes[i]),
        "cached_v": jnp.asarray(codes[DEPTH + i]),
        "scale_k": jnp.asarray(scales[i]),
        "scale_v": jnp.asarray(scales[DEPTH + i])}} for i in range(DEPTH)}
    want, mut = jm.apply(
        {"params": params, "cache": jcache}, jnp.asarray(tokens),
        train=False, decode=True, pos_offset=jnp.asarray(positions, jnp.int32),
        decode_active=jnp.asarray(active),
        paged_kv=JaxPagedKV(pages=PAGES, page_tokens=PT, dtype="int8"),
        page_table=jnp.asarray(table), mutable=["cache"])
    leaves = [torch.from_numpy(a.copy()) for a in codes + scales]
    pool = KVCache(tuple(leaves[:DEPTH]), tuple(leaves[DEPTH:2 * DEPTH]), 0,
                   tuple(leaves[2 * DEPTH:3 * DEPTH]),
                   tuple(leaves[3 * DEPTH:]))
    with torch.inference_mode():
        got, _ = pm(torch.from_numpy(tokens),
                    pos_offset=torch.tensor(positions), cache=pool,
                    decode_active=torch.tensor(active),
                    paged_kv=PagedKV(pages=PAGES, page_tokens=PT,
                                     dtype="int8"),
                    page_table=torch.from_numpy(table))
    want = np.asarray(want)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The rows written (page 0, the garbage page, aside): codes at most
    # one apart where float32 K/V round differently across a .5, scales
    # within float32 rounding.
    for i in range(DEPTH):
        layer = mut["cache"][f"block{i:02d}"]["attn"]
        for name, got_t in (("cached_k", pool.k[i]), ("cached_v", pool.v[i])):
            d = np.abs(got_t.numpy()[PT:].astype(np.int32)
                       - np.asarray(layer[name])[PT:].astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3
        for name, got_t in (("scale_k", pool.sk[i]), ("scale_v", pool.sv[i])):
            np.testing.assert_allclose(got_t.numpy()[PT:],
                                       np.asarray(layer[name])[PT:],
                                       rtol=1e-6)


@pytest.fixture(scope="module")
def gate_tokens(gate_lm):
    """The 6 gate prompts' 6 greedy tokens through tpunet's int8 engine,
    the port's int8 engine, and the port's float32 generate."""
    model, variables, pm = gate_lm
    ps = [gate_prompt(s) for s in GATE_SEEDS]
    eng = JaxEngine(model, variables, JaxServeConfig(
        slots=4, queue_max=16, prefill_buckets=(8, 16),
        default_max_new_tokens=6, emit_every_s=0.0, kv_dtype="int8")).start()
    try:
        jax_int8 = [eng.submit(p, max_new_tokens=6).result(timeout=300)
                    for p in ps]
    finally:
        eng.stop()
    eng = make_engine(pm, kv_dtype="int8").start()
    try:
        port_int8 = [eng.submit(p, max_new_tokens=6).result(timeout=300)
                     for p in ps]
    finally:
        eng.stop()
    f32 = [generate(pm, torch.from_numpy(p.astype(np.int64))[None],
                    6)[0, len(p):].tolist() for p in ps]
    return jax_int8, port_int8, f32


@pytest.mark.parametrize("seed", GATE_SEEDS)
def test_int8_engine_greedy_equals_tpunet_int8(gate_tokens, seed):
    jax_int8, port_int8, _ = gate_tokens
    assert port_int8[seed] == jax_int8[seed]


def test_int8_changes_seed_2_in_both_packages(gate_tokens):
    """The reference's finding, reproduced: int8 KV flips seed 2's greedy
    stream at index 2 in both packages, and leaves the others as float32
    has them."""
    jax_int8, port_int8, f32 = gate_tokens
    assert port_int8[2][:2] == f32[2][:2] and port_int8[2][2] != f32[2][2]
    assert jax_int8[2] == port_int8[2]


def test_int8_kv_halves_bf16_page_cost(gate_lm):
    """int8 pages (payload + scale sidecar) cost less than half the
    float32 pages and at most 60% of bf16 pages at this head size."""
    pm = gate_lm[2]
    sizes = {dtype: make_engine(pm, kv_dtype=dtype).kv_bytes_per_token()
             for dtype in ("auto", "bf16", "int8")}
    assert sizes["int8"] < sizes["auto"] / 2
    assert sizes["int8"] < sizes["bf16"] * 0.6
    assert sizes["bf16"] == pytest.approx(sizes["auto"] / 2)
    # 2 layers x (K, V) x (2 heads x 16 codes + a float32 scale)
    assert sizes["int8"] == 2 * 2 * (H * D + 4)


def test_int8_requires_paged_kv(gate_lm):
    with pytest.raises(ValueError, match="requires the paged KV"):
        make_engine(gate_lm[2], paged_kv=False, kv_dtype="int8")
