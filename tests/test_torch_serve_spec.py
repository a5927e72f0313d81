"""The port's speculative decoding (``tpunet_torch.serve.spec`` and the
engine's draft/verify cycle) against tpunet's, on the CPU.

``accept_drafts`` and ``drafter_model_config`` against tpunet's on
seeded cases; the drafter's npz crossing both ways (tpunet's file into
the port, the port's into tpunet, the same logits); ``fit_drafter``
against tpunet's for 3 steps from the same weights and prompts. Then the
counterparts of tpunet's spec engine tests (tests/test_serve_paged.py):
the config refusals, greedy spec-on tokens equal to spec-off's at both
ends of acceptance (self-speculation, a seeded half-width drafter), a
sampled stream the same with spec on and off and across a preemption,
rewind page recycling, the clamp at pinned prefix pages, the record and
instruments; and greedy spec-on tokens against tpunet's spec engine's.
tests/test_serve.py's TINY LM (hidden 32, depth 2, 2 heads, vocab 31,
max_seq_len 48, float32) with tpunet's init redrawn from numpy.
"""

import numpy as np
import pytest
import torch

import jax

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import ServeConfig as JaxServeConfig
from tpunet.models import init_variables
from tpunet.serve import Engine as JaxEngine
from tpunet.serve import spec as jax_spec
from tpunet_torch.config import ModelConfig, ServeConfig
from tpunet_torch.models.convert import (load_state_dict, lm_params_to_jax,
                                         lm_state_dict_from_jax)
from tpunet_torch.models.lm import generate
from tpunet_torch.serve import Engine
from tpunet_torch.serve import spec
from tpunet_torch.serve.engine import build_serve_record

from _torch_port import jax_lm, lm_params, port_lm
import _torch_threads  # noqa: E402,F401

TINY = dict(vocab_size=31, max_seq_len=48)
VOCAB = TINY["vocab_size"]
DRAFT_HIDDEN = 16            # width 0.5 of 32, two heads of 8


@pytest.fixture(scope="module")
def lm():
    params = lm_params(0, **TINY)
    return params, port_lm(params, "dense", **TINY)


@pytest.fixture(scope="module")
def drafter_params():
    """tpunet's init of the half-width drafter, as numpy."""
    drafter = jax_lm(**TINY).clone(hidden=DRAFT_HIDDEN)
    v = init_variables(drafter, jax.random.PRNGKey(1), seq_len=16)
    return jax.tree_util.tree_map(np.asarray, v["params"])


def port_drafter(lm, params):
    """The port's half-width drafter holding tpunet's ``params``."""
    d = lm[1].clone(hidden=DRAFT_HIDDEN)
    load_state_dict(d, lm_state_dict_from_jax(params))
    return d


def prompts(n, rng_seed=0, lo=2, hi=9):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def solo_greedy(lm, prompt, n):
    return generate(lm[1], torch.from_numpy(prompt.astype(np.int64))[None],
                    n)[0, len(prompt):].tolist()


def make_engine(lm, **cfg_kw):
    cfg_kw.setdefault("slots", 4)
    cfg_kw.setdefault("queue_max", 16)
    cfg_kw.setdefault("prefill_buckets", (8, 16))
    cfg_kw.setdefault("default_max_new_tokens", 6)
    cfg_kw.setdefault("emit_every_s", 0.0)
    return Engine(lm[1], ServeConfig(**cfg_kw))


def run(lm, ps, kw, **cfg_kw):
    eng = make_engine(lm, **cfg_kw).start()
    try:
        reqs = [eng.submit(p, **kw) for p in ps]
        return eng, [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()


def pool_clean(eng) -> bool:
    """Every usable page is on the free list or resident in the prefix
    cache — a rewind or release that dropped a page shows up here."""
    cached = eng._prefix.pages_cached if eng._prefix else 0
    return len(eng._free_pages) + cached == eng.kv_pages_usable


# ---------------------------------------------------------------------------
# the pure parts, against tpunet's
# ---------------------------------------------------------------------------

def test_accept_drafts_and_drafter_config_equal_tpunet():
    rng = np.random.default_rng(0)
    for k in (1, 3, 4):
        choices = rng.integers(0, 3, size=(64, k + 1))
        drafts = np.where(rng.random((64, k)) < 0.7, choices[:, :-1],
                          rng.integers(0, 3, size=(64, k)))
        got = spec.accept_drafts(drafts, choices)
        np.testing.assert_array_equal(
            got, jax_spec.accept_drafts(drafts, choices))
        assert got.min() == 0 and got.max() == k
    with pytest.raises(ValueError, match="shape mismatch"):
        spec.accept_drafts(np.zeros((2, 3)), np.zeros((2, 3)))
    for hidden, heads in ((768, 12), (32, 2), (192, 3)):
        cfg = ModelConfig(name="lm", vit_hidden=hidden, vit_heads=heads)
        jcfg = JaxModelConfig(name="lm", vit_hidden=hidden, vit_heads=heads)
        for wm in (0.01, 0.25, 0.5, 1.0):
            assert spec.drafter_model_config(cfg, wm).vit_hidden == \
                jax_spec.drafter_model_config(jcfg, wm).vit_hidden
    with pytest.raises(ValueError, match="must be > 0"):
        spec.drafter_model_config(ModelConfig(name="lm"), 0.0)


def test_drafter_npz_crosses_both_ways(lm, drafter_params, tmp_path):
    """tpunet's drafter file loads into the port and the port's into
    tpunet: the same weights, the same logits; a drafter of another
    width is refused with tpunet's message."""
    toks = np.random.default_rng(1).integers(0, VOCAB, (2, 10))
    jd = jax_lm(**TINY).clone(hidden=DRAFT_HIDDEN)
    want = np.asarray(jd.apply({"params": drafter_params}, toks,
                               train=False))
    jax_file = str(tmp_path / "jax.npz")
    jax_spec.save_drafter_params(jax_file, drafter_params)
    template = lm[1].clone(hidden=DRAFT_HIDDEN)
    sd = spec.load_drafter_params(jax_file, template)
    load_state_dict(template, sd)
    with torch.no_grad():
        got = template(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    port_file = str(tmp_path / "port.npz")
    spec.save_drafter_params(port_file, template.state_dict())
    back = jax_spec.load_drafter_params(port_file, drafter_params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(drafter_params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="has shape"):
        spec.load_drafter_params(jax_file, lm[1].clone(hidden=32))


def test_fit_drafter_matches_tpunet(lm, drafter_params):
    """3 steps of the distillation from the same teacher, drafter init
    and prompts: the fitted weights within 1e-4 of the largest weight of
    each leaf. Left out: the key projection's bias, whose exact gradient
    is 0 (a shift of every score of a query leaves its softmax as it
    is), so its computed gradient is float noise, which Adam's first
    steps scale to +-lr in either package."""
    params = lm[0]
    ps = np.random.default_rng(5).integers(0, VOCAB, (4, 6)).astype(np.int32)
    want = jax_spec.fit_drafter(
        jax_lm(**TINY), params, jax_lm(**TINY).clone(hidden=DRAFT_HIDDEN),
        drafter_params, ps, gen_tokens=8, steps=3)
    d = port_drafter(lm, drafter_params)
    got = lm_params_to_jax(spec.fit_drafter(lm[1], d, ps, gen_tokens=8,
                                            steps=3))
    moved = 0.0
    for (path, w), g, w0 in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree_util.tree_leaves(got),
            jax.tree_util.tree_leaves(drafter_params)):
        w = np.asarray(w)
        if path[-2:] == (jax.tree_util.DictKey("qkv"),
                         jax.tree_util.DictKey("bias")):
            keys = slice(DRAFT_HIDDEN, 2 * DRAFT_HIDDEN)
            w, g, w0 = (np.delete(a, keys) for a in (w, g, w0))
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-4 * scale, path
        moved = max(moved, np.abs(w - w0).max())
    assert moved > 1e-3          # 3 Adam steps of lr 3e-3 moved weights


# ---------------------------------------------------------------------------
# the engine's spec cycle (tpunet's tests/test_serve_paged.py:706-860)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(paged_kv=False),
                                 dict(device_sampling=False),
                                 dict(spec_k=0),
                                 dict(spec_draft_width_mult=0.0)])
def test_spec_config_requires_paged_and_device_sampling(lm, bad):
    with pytest.raises(ValueError):
        make_engine(lm, spec_decode=True, **bad)


@pytest.mark.parametrize("wm", [1.0, 0.5])
def test_spec_greedy_bitwise_identical_both_acceptance_extremes(lm, wm):
    """Self-speculation (every draft accepted) and a seeded half-width
    drafter (almost every draft rejected) emit spec-off's greedy tokens:
    every emitted token comes from the verify."""
    ps = prompts(5, rng_seed=7)
    eng, outs = run(lm, ps, dict(max_new_tokens=10), spec_decode=True,
                    spec_k=3, spec_draft_width_mult=wm)
    assert outs == [solo_greedy(lm, p, 10) for p in ps]
    snap = eng.registry.snapshot()
    drafted = snap["serve_spec_draft_tokens_total"]
    acc = snap["serve_spec_accepted_tokens_total"]
    rej = snap["serve_spec_rejected_tokens_total"]
    assert drafted > 0 and snap["serve_spec_verify_steps_total"] > 0
    assert acc + rej == drafted
    if wm == 1.0:
        assert acc == drafted, "self-speculation must accept all"
    else:
        assert rej > 0, "a random drafter should see rejections"
    assert pool_clean(eng), "rewind/release leaked a page"


def test_spec_sampled_stream_identical_and_preempt_deterministic(lm):
    """Sampled requests: spec-on draws each position at the (seed, step)
    the sequential loop would, so the stream is spec-off's — also across
    a pool-pressure preemption, where the resumed slot continues its
    sample sequence."""
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=5, seed=123)
    ps = prompts(4, rng_seed=11, lo=6, hi=7)
    _, base = run(lm, ps, kw)
    eng_on, sampled = run(lm, ps, kw, spec_decode=True, spec_k=3,
                          spec_draft_width_mult=0.5)
    assert sampled == base, "spec-on sampled stream diverged"
    assert pool_clean(eng_on)
    eng_tight, tight = run(lm, ps, kw, spec_decode=True, spec_k=3,
                           spec_draft_width_mult=0.5, slots=2, kv_pages=5,
                           kv_page_tokens=4)
    assert tight == base, "preempt-resume broke sample determinism"
    assert eng_tight.registry.snapshot()["serve_kv_preemptions_total"] >= 1
    assert pool_clean(eng_tight)


def test_spec_rejection_rewind_recycles_pages(lm):
    """Every burst allocates pages through pos+K and a rejecting drafter
    rewinds most of them: churn over a small pool until every page has
    been reused; greedy parity shows no stale K/V, and at quiesce the
    whole pool is free."""
    eng = make_engine(lm, slots=2, kv_pages=8, kv_page_tokens=4,
                      prefix_cache=False, spec_decode=True, spec_k=3,
                      spec_draft_width_mult=0.5).start()
    try:
        for wave in range(3):
            ps = prompts(4, rng_seed=300 + wave, lo=5, hi=9)
            reqs = [eng.submit(p, max_new_tokens=8) for p in ps]
            for p, r in zip(ps, reqs):
                assert r.result(timeout=120) == solo_greedy(lm, p, 8)
        snap = eng.registry.snapshot()
        assert snap["serve_spec_rejected_tokens_total"] > 0
        assert snap["serve_kv_page_allocs_total"] > eng.kv_pages_usable
        assert len(eng._free_pages) == eng.kv_pages_usable
        assert snap["serve_kv_pages_used"] == 0
    finally:
        eng.stop()


def test_spec_rewind_clamps_at_pinned_prefix_pages(lm):
    """A rejection rewind never frees or rewrites a page the slot pinned
    from the prefix cache: later requests keep hitting the same cached
    pages and stay equal to generate's tokens."""
    eng = make_engine(lm, slots=2, kv_pages=16, kv_page_tokens=4,
                      spec_decode=True, spec_k=3,
                      spec_draft_width_mult=0.5).start()
    try:
        p = np.random.default_rng(23).integers(0, VOCAB, size=8).astype(
            np.int32)
        outs = [eng.submit(p, max_new_tokens=6).result(timeout=120)
                for _ in range(3)]
        snap = eng.registry.snapshot()
        assert snap["serve_prefix_hits_total"] >= 2
        assert snap["serve_spec_rejected_tokens_total"] > 0
        assert pool_clean(eng)
    finally:
        eng.stop()
    assert outs == [solo_greedy(lm, p, 6)] * 3


def test_spec_serve_record_and_instruments(lm):
    eng, _ = run(lm, prompts(1, rng_seed=3), dict(max_new_tokens=8),
                 spec_decode=True, spec_k=3, spec_draft_width_mult=1.0)
    rec = build_serve_record(eng.registry, queue_depth=0, active_slots=0,
                             slots=4, uptime_s=1.0, window_s=1.0)
    assert rec["spec_draft_tokens_total"] > 0
    assert rec["spec_accepted_tokens_total"] \
        + rec["spec_rejected_tokens_total"] == rec["spec_draft_tokens_total"]
    assert rec["spec_verify_steps_total"] > 0
    assert rec["spec_acceptance_rate"] == 1.0   # self-speculation
    assert rec["spec_accepted_tokens_per_verify"] > 0
    assert eng.registry.snapshot()["serve_spec_acceptance_rate"] == 1.0
    assert eng.drafter_pool_bytes() == eng.kv_pool_bytes()
    half = make_engine(lm, spec_decode=True, spec_draft_width_mult=0.5)
    assert half.drafter_pool_bytes() == half.kv_pool_bytes() // 2


def test_spec_greedy_equals_tpunet_spec_engine(lm):
    """Greedy spec-on tokens of the port's engine and tpunet's, with a
    drafter of the same width (each package's own seeded init)."""
    ps = prompts(4, rng_seed=17)
    cfg = dict(slots=4, queue_max=16, prefill_buckets=(8, 16),
               emit_every_s=0.0, spec_decode=True, spec_k=3,
               spec_draft_width_mult=0.5)
    eng = JaxEngine(jax_lm(**TINY), {"params": lm[0]},
                    JaxServeConfig(**cfg)).start()
    try:
        want = [eng.submit(p, max_new_tokens=8).result(timeout=300)
                for p in ps]
    finally:
        eng.stop()
    _, got = run(lm, ps, dict(max_new_tokens=8), **cfg)
    assert got == want
