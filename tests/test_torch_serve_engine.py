"""The port's serving engine (``tpunet_torch.serve.Engine``) against
tpunet's, on the CPU.

tests/test_serve.py's TINY LM (hidden 32, depth 2, 2 heads, vocab 31,
max_seq_len 48, float32) with tpunet's init redrawn from numpy
(``_torch_port.lm_params``), carried across with
``lm_state_dict_from_jax``. Greedy tokens must be IDENTICAL to tpunet's
``Engine`` (one run over every prompt used here, the module's
reference) and to the port's ``generate`` in each case: mid-flight
admission and slot reuse, paged against dense, the host sampler,
preempt and resume, a prefix hit (suffix-only prefill), copy-on-write of
an identical prompt, prefix cache on and off. Then the lifecycle cases of
the tests of the same names in tests/test_serve.py and
tests/test_serve_paged.py: queue-full, prompt-too-long and budget
clamps, deadline, cancel, drain, drain timeout, stop, engine failure and
the finish accounting; and the device sampler's (seed, step) stream
across preemption and ``resume_tokens``.
"""

import time

import numpy as np
import pytest
import torch

from tpunet.config import ServeConfig as JaxServeConfig
from tpunet.serve import Engine as JaxEngine
from tpunet_torch.config import ServeConfig
from tpunet_torch.models.lm import generate
from tpunet_torch.serve import (Engine, GenerateRequest, PromptTooLongError,
                                QueueFullError, RequestQueue)
from tpunet_torch.serve.engine import _Slot
from tpunet_torch.serve.scheduler import DrainingError

from _torch_port import jax_lm, lm_params, port_lm
import _torch_threads  # noqa: E402,F401

TINY = dict(vocab_size=31, max_seq_len=48)
VOCAB = TINY["vocab_size"]
NEW = 12                     # the reference's budget; cases take prefixes


def prompts(n, rng_seed=0, lo=2, hi=9):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def shared_prefix_prompts():
    """An 8-token shared prefix (two pages of 4) with short suffixes, and
    a page-aligned 8-token prompt with a variant diverging inside its
    second page."""
    rng = np.random.default_rng(13)
    shared = rng.integers(0, VOCAB, size=8).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(0, VOCAB, size=k)
                           .astype(np.int32)]) for k in (3, 2, 5, 1)]
    p = rng.integers(0, VOCAB, size=8).astype(np.int32)
    q = p.copy()
    q[5] = (int(q[5]) + 1) % VOCAB
    return out + [p, q]


ALL = (prompts(8) + prompts(3, rng_seed=1) + prompts(4, rng_seed=1, lo=6,
                                                      hi=7)
       + prompts(4, rng_seed=100, lo=5, hi=9) + shared_prefix_prompts())


@pytest.fixture(scope="module")
def lm():
    params = lm_params(0, **TINY)
    return params, port_lm(params, "dense", **TINY)


@pytest.fixture(scope="module")
def reference(lm):
    """tpunet's Engine (its defaults: paged KV, prefix cache, device
    sampling) over every prompt of this file: prompt bytes -> its NEW
    greedy tokens."""
    params, _ = lm
    cfg = JaxServeConfig(slots=4, queue_max=64, prefill_buckets=(8, 16),
                         emit_every_s=0.0)
    eng = JaxEngine(jax_lm(**TINY), {"params": params}, cfg).start()
    try:
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in ALL]
        outs = [r.result(timeout=300) for r in reqs]
    finally:
        eng.stop()
    return {p.tobytes(): o for p, o in zip(ALL, outs)}


def expect(reference, lm, prompt, n):
    """tpunet Engine's first ``n`` greedy tokens, checked against the
    port's generate."""
    want = reference[np.asarray(prompt, np.int32).tobytes()][:n]
    solo = generate(lm[1], torch.from_numpy(prompt.astype(np.int64))[None],
                    n)[0, len(prompt):].tolist()
    assert solo == want, "port generate disagrees with tpunet's Engine"
    return want


def make_engine(lm, **cfg_kw):
    cfg_kw.setdefault("slots", 4)
    cfg_kw.setdefault("queue_max", 16)
    cfg_kw.setdefault("prefill_buckets", (8, 16))
    cfg_kw.setdefault("default_max_new_tokens", 6)
    cfg_kw.setdefault("emit_every_s", 0.0)
    return Engine(lm[1], ServeConfig(**cfg_kw))


def slow(eng, delay=0.05):
    real = eng._step

    def step(*a):
        time.sleep(delay)
        return real(*a)

    eng._step = step


# ---------------------------------------------------------------------------
# greedy parity with tpunet's Engine and generate
# ---------------------------------------------------------------------------

def test_mid_flight_admission_matches_tpunet(lm, reference):
    """8 requests through 2 slots, admitted in waves so later ones join
    while earlier ones decode (queueing and slot reuse)."""
    eng = make_engine(lm, slots=2).start()
    try:
        ps = prompts(8)
        reqs = []
        for i, p in enumerate(ps):
            reqs.append(eng.submit(p, max_new_tokens=5))
            if i % 3 == 2:
                time.sleep(0.02)
        outs = [r.result(timeout=120) for r in reqs]
        snap = eng.registry.snapshot()
    finally:
        eng.stop()
    for p, out, req in zip(ps, outs, reqs):
        assert out == expect(reference, lm, p, 5)
        assert req.finish_reason == "length"
    assert snap["serve_requests_completed"] == 8
    assert snap["serve_ttft_s_count"] == 8
    assert eng.active_slots() == 0


def test_slot_reuse_across_staggered_requests(lm, reference):
    eng = make_engine(lm, slots=1).start()
    try:
        for p in prompts(3, rng_seed=1):
            out = eng.submit(p, max_new_tokens=4).result(timeout=60)
            assert out == expect(reference, lm, p, 4)
    finally:
        eng.stop()


@pytest.mark.parametrize("kw", [dict(paged_kv=False),
                                dict(device_sampling=False),
                                dict(paged_kv=False, device_sampling=False)],
                         ids=["dense", "host_sampler", "dense_host_sampler"])
def test_pool_and_sampler_variants_match_tpunet(lm, reference, kw):
    eng = make_engine(lm, slots=2, **kw).start()
    try:
        ps = prompts(8)
        reqs = []
        for i, p in enumerate(ps):
            reqs.append(eng.submit(p, max_new_tokens=5))
            if i % 2 == 1:
                time.sleep(0.01)
        outs = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    assert outs == [expect(reference, lm, p, 5) for p in ps]


def test_preempt_and_resume_match_tpunet(lm, reference):
    """5 usable pages of 4 tokens cannot hold two full-length residents:
    the youngest blocked slot is preempted and resumed by re-prefilling
    prompt + generated, token-identically."""
    eng = make_engine(lm, slots=2, kv_pages=5, kv_page_tokens=4).start()
    try:
        ps = prompts(4, rng_seed=1, lo=6, hi=7)
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in ps]
        outs = [r.result(timeout=120) for r in reqs]
        snap = eng.registry.snapshot()
    finally:
        eng.stop()
    assert outs == [expect(reference, lm, p, NEW) for p in ps]
    assert snap["serve_kv_preemptions_total"] >= 1
    assert sum(r.preemptions for r in reqs) >= 1


def test_page_recycling_no_stale_kv_bleed(lm, reference):
    """Churn a pool two residents exhaust until every page was reused."""
    eng = make_engine(lm, slots=2, kv_pages=8, kv_page_tokens=4,
                      prefix_cache=False).start()
    try:
        ps = prompts(4, rng_seed=100, lo=5, hi=9)
        for _ in range(3):
            reqs = [eng.submit(p, max_new_tokens=8) for p in ps]
            assert [r.result(timeout=120) for r in reqs] == \
                [expect(reference, lm, p, 8) for p in ps]
        snap = eng.registry.snapshot()
    finally:
        eng.stop()
    assert eng._kv_pages_touched == set(range(1, 9))
    assert snap["serve_kv_page_allocs_total"] > 8
    assert len(eng._free_pages) == 8 and snap["serve_kv_pages_used"] == 0


def test_prefix_hit_prefills_suffix_only(lm, reference):
    """A second request sharing two cached prompt pages pins them and
    prefills only its suffix (serve_prefill_tokens_total's delta)."""
    eng = make_engine(lm, slots=2, kv_pages=16, kv_page_tokens=4).start()
    p1, p2 = shared_prefix_prompts()[:2]
    try:
        out1 = eng.submit(p1, max_new_tokens=5).result(timeout=120)
        pre1 = eng.registry.snapshot()["serve_prefill_tokens_total"]
        out2 = eng.submit(p2, max_new_tokens=5).result(timeout=120)
        snap = eng.registry.snapshot()
    finally:
        eng.stop()
    assert pre1 == p1.size
    assert snap["serve_prefill_tokens_total"] - pre1 == p2.size - 8
    assert snap["serve_prefix_hits_total"] >= 1
    assert snap["serve_prefix_hit_tokens_total"] >= 8
    assert out1 == expect(reference, lm, p1, 5)
    assert out2 == expect(reference, lm, p2, 5)


def test_prefix_cow_identical_prompt_and_divergence(lm, reference):
    """An identical page-aligned prompt copies its last cached page
    (COW) and prefills one token; a prompt diverging inside its second
    page pins the first only; the shared source page stays intact."""
    p, q = shared_prefix_prompts()[4:]
    eng = make_engine(lm, slots=2, kv_pages=16, kv_page_tokens=4).start()
    try:
        out1 = eng.submit(p, max_new_tokens=6).result(timeout=120)
        out2 = eng.submit(p, max_new_tokens=6).result(timeout=120)
        cow = eng.registry.snapshot()["serve_prefix_cow_total"]
        out3 = eng.submit(q, max_new_tokens=6).result(timeout=120)
        snap = eng.registry.snapshot()
        out4 = eng.submit(p, max_new_tokens=6).result(timeout=120)
    finally:
        eng.stop()
    assert cow >= 1 and snap["serve_prefix_cow_total"] == cow
    assert snap["serve_prefix_hits_total"] >= 2
    assert out1 == out2 == out4 == expect(reference, lm, p, 6)
    assert out3 == expect(reference, lm, q, 6)


def test_prefix_cache_on_off_dense_identical(lm, reference):
    ps = shared_prefix_prompts()[:4]
    outs = {}
    for label, kw in (("cache", {}), ("nocache", {"prefix_cache": False}),
                      ("dense", {"paged_kv": False})):
        eng = make_engine(lm, slots=2, **kw).start()
        try:
            outs[label] = [eng.submit(p, max_new_tokens=5)
                           .result(timeout=120) for p in ps]
        finally:
            eng.stop()
    assert outs["cache"] == outs["nocache"] == outs["dense"] == \
        [expect(reference, lm, p, 5) for p in ps]


def test_preempt_victim_prefers_resumable_slots(lm):
    eng = make_engine(lm)          # buckets (8, 16)

    def slot(n_prompt, n_gen, seq):
        s = _Slot(GenerateRequest(np.ones(n_prompt, np.int32),
                                  max_new_tokens=30),
                  pos=n_prompt + n_gen, next_token=1, seq=seq)
        s.req.tokens.extend([1] * n_gen)
        return s

    old_long, young_short, young_long = slot(6, 14, 1), slot(4, 4, 2), \
        slot(6, 14, 3)
    assert eng._choose_preempt_victim([(0, old_long), (1, young_short)]) == 1
    assert eng._choose_preempt_victim([(1, young_short),
                                       (2, young_long)]) == 1
    assert eng._choose_preempt_victim([(0, old_long), (2, young_long)]) == 2


# ---------------------------------------------------------------------------
# the device sampler's stream: deterministic per (seed, step)
# ---------------------------------------------------------------------------

def test_sampled_stream_survives_preemption_and_resume_tokens(lm):
    """A sampled request's tokens depend on its seed alone: the same
    with a partner, through a preemption, and continued from
    ``resume_tokens`` (a router failover) without re-emitting them."""
    p = prompts(1, rng_seed=1, lo=6, hi=7)[0]
    kw = dict(max_new_tokens=NEW, temperature=1.0, top_k=10, top_p=0.9,
              seed=7)
    eng = make_engine(lm, slots=1).start()
    try:
        alone = eng.submit(p, **kw).result(timeout=120)
        other = eng.submit(p, **dict(kw, seed=8)).result(timeout=120)
    finally:
        eng.stop()
    assert alone != other and all(0 <= t < VOCAB for t in alone)
    eng = make_engine(lm, slots=2, kv_pages=5, kv_page_tokens=4).start()
    try:
        reqs = [eng.submit(p, **kw), eng.submit(p, **dict(kw, seed=8))]
        outs = [r.result(timeout=120) for r in reqs]
        resumed = eng.submit(p, resume_tokens=alone[:5], **kw)
        events = list(resumed.events(timeout=120))
        snap = eng.registry.snapshot()
    finally:
        eng.stop()
    assert snap["serve_kv_preemptions_total"] >= 1
    assert outs == [alone, other]
    assert resumed.result(timeout=1) == alone
    assert [v for k, v in events if k == "token"] == alone[5:]


def test_sampled_resume_needs_the_device_sampler(lm):
    eng = make_engine(lm, device_sampling=False)
    with pytest.raises(ValueError, match="device-side"):
        eng.submit([1, 2], max_new_tokens=4, temperature=1.0,
                   resume_tokens=[3])


# ---------------------------------------------------------------------------
# admission control, budgets, deadlines, cancel, drain, failure
# ---------------------------------------------------------------------------

def test_queue_full_rejection():
    q = RequestQueue(queue_max=2)
    q.submit(GenerateRequest([1], max_new_tokens=1))
    q.submit(GenerateRequest([1], max_new_tokens=1))
    with pytest.raises(QueueFullError):
        q.submit(GenerateRequest([1], max_new_tokens=1))
    assert q.depth() == 2


def test_engine_rejects_when_queue_bound_hit(lm):
    eng = make_engine(lm, slots=1, queue_max=2)     # NOT started
    eng.submit([1, 2], max_new_tokens=2)
    eng.submit([1, 2], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        eng.submit([1, 2], max_new_tokens=2)
    snap = eng.registry.snapshot()
    assert snap["serve_requests_rejected"] == 1
    assert snap["serve_requests_total"] == 2


def test_prompt_too_long_and_budget_clamps(lm):
    eng = make_engine(lm)                            # buckets (8, 16)
    with pytest.raises(PromptTooLongError):
        eng.submit(np.zeros(17, np.int32))
    with pytest.raises(PromptTooLongError):
        make_engine(lm, prefill_buckets=(48,)).submit(np.zeros(48, np.int32))
    with pytest.raises(PromptTooLongError):          # the pool's guard
        make_engine(lm, slots=2, kv_pages=5, kv_page_tokens=4).submit(
            np.ones(8, np.int32), max_new_tokens=40)
    eng = make_engine(lm, prefill_buckets=(48,),
                      max_new_tokens_cap=2048).start()
    try:
        req = eng.submit(np.ones(40, np.int32), max_new_tokens=100)
        assert len(req.result(timeout=60)) == 8
        assert req.finish_reason == "length"
        assert (req.requested_max_new_tokens, req.max_new_tokens) == (100, 8)
    finally:
        eng.stop()
    r2 = make_engine(lm, max_new_tokens_cap=3).submit(np.ones(4, np.int32),
                                                      max_new_tokens=50)
    assert (r2.requested_max_new_tokens, r2.max_new_tokens) == (50, 3)


def test_seed_validated_at_admission():
    with pytest.raises(ValueError, match="seed"):
        GenerateRequest(np.arange(1, 4), max_new_tokens=2, seed=-3)
    with pytest.raises(ValueError, match="seed"):
        GenerateRequest(np.arange(1, 4), max_new_tokens=2, seed=2 ** 31)


def test_stop_token_finishes_early(lm, reference):
    p = prompts(1)[0]
    first = expect(reference, lm, p, 1)[0]
    eng = make_engine(lm).start()
    try:
        req = eng.submit(p, max_new_tokens=6, stop_token=int(first))
        assert req.result(timeout=60) == [first]
        assert req.finish_reason == "stop"
    finally:
        eng.stop()


def test_deadline_cancellation_frees_the_slot(lm, reference):
    eng = make_engine(lm, slots=1, default_max_new_tokens=40)
    slow(eng, 0.01)
    eng.start()
    try:
        p = prompts(1)[0]
        doomed = eng.submit(p, max_new_tokens=40, deadline_s=0.001)
        doomed.result(timeout=60)
        assert doomed.finish_reason == "deadline"
        assert len(doomed.tokens) < 40
        out = eng.submit(p, max_new_tokens=4).result(timeout=60)
        assert out == expect(reference, lm, p, 4)
        assert eng.registry.snapshot()["serve_finished_deadline"] == 1
    finally:
        eng.stop()


def test_client_cancel_frees_the_slot(lm):
    eng = make_engine(lm, slots=1, default_max_new_tokens=40)
    slow(eng, 0.01)
    eng.start()
    try:
        req = eng.submit(prompts(1)[0], max_new_tokens=40)
        next(iter(req.events(timeout=60)))
        req.cancel()
        req.result(timeout=60)
        assert req.finish_reason == "cancelled"
        assert eng.active_slots() == 0
    finally:
        eng.stop()


def test_graceful_drain_finishes_in_flight(lm, reference):
    eng = make_engine(lm, slots=1).start()
    try:
        ps = prompts(3)
        reqs = [eng.submit(p, max_new_tokens=4) for p in ps]
        assert eng.drain(timeout=120.0)
        for p, req in zip(ps, reqs):
            assert req.finish_reason == "length"
            assert list(req.tokens) == expect(reference, lm, p, 4)
        with pytest.raises(DrainingError):
            eng.submit(ps[0])
    finally:
        eng.stop()


def test_drain_timeout_finishes_survivors_with_drain_reason(lm):
    eng = make_engine(lm, slots=1, default_max_new_tokens=40)
    slow(eng)
    eng.start()
    inflight = eng.submit(prompts(1)[0], max_new_tokens=40)
    queued = eng.submit(prompts(1, rng_seed=1)[0], max_new_tokens=40)
    next(iter(inflight.events(timeout=60)))
    assert not eng.drain(timeout=0.05)
    inflight.result(timeout=30)
    queued.result(timeout=30)
    assert inflight.finish_reason == queued.finish_reason == "drain"
    assert eng.registry.snapshot()["serve_finished_drain"] == 2
    assert eng.active_slots() == 0


def test_stop_unblocks_waiting_clients(lm):
    eng = make_engine(lm, slots=1, default_max_new_tokens=40)
    slow(eng)
    eng.start()
    req = eng.submit(prompts(1)[0], max_new_tokens=40)
    next(iter(req.events(timeout=60)))
    t0 = time.perf_counter()
    eng.stop()
    req.result(timeout=5)
    assert time.perf_counter() - t0 < 15
    assert req.done and req.finish_reason == "cancelled"


def test_drain_never_started_engine_returns_fast(lm):
    eng = make_engine(lm, slots=1)                  # NOT started
    queued = eng.submit(prompts(1)[0], max_new_tokens=4)
    t0 = time.perf_counter()
    assert not eng.drain(timeout=30.0)
    assert time.perf_counter() - t0 < 5
    assert queued.done and queued.finish_reason == "drain"
    assert eng.registry.snapshot()["serve_finished_drain"] == 1
    assert make_engine(lm, slots=1).drain(timeout=30.0)


def test_queued_cancel_and_deadline_are_accounted(lm):
    """requests_total == rejected + sum(finished_*), also for requests
    finished while still queued."""
    eng = make_engine(lm, slots=1, default_max_new_tokens=40)
    slow(eng)
    eng.start()
    try:
        hog = eng.submit(prompts(1)[0], max_new_tokens=20)
        victim = eng.submit(prompts(1, rng_seed=1)[0], max_new_tokens=4)
        expired = eng.submit(prompts(1, rng_seed=2)[0], max_new_tokens=4,
                             deadline_s=0.01)
        victim.cancel()
        for r in (victim, expired, hog):
            r.result(timeout=60)
        assert (victim.finish_reason, expired.finish_reason,
                hog.finish_reason) == ("cancelled", "deadline", "length")
        snap = eng.registry.snapshot()
        finished = sum(v for k, v in snap.items()
                       if k.startswith("serve_finished_"))
        assert finished + snap.get("serve_requests_rejected", 0) == \
            snap["serve_requests_total"] == 3
    finally:
        eng.stop()


def test_engine_failure_fails_requests_and_health(lm):
    """A raising device step (no fallback) ends the engine: in-flight and
    queued requests fail fast with the error, health flips, new submits
    are refused, and the dead loop's thread handle is idle (not a stall
    for the process's watchdogs)."""
    eng = make_engine(lm, slots=1, default_max_new_tokens=40)

    def boom(*a):
        raise RuntimeError("device fell over")

    eng._step = boom
    eng.start()
    try:
        req = eng.submit(prompts(1)[0])
    except DrainingError:
        req = None
    if req is not None:
        req.result(timeout=60)
        assert req.finish_reason == "error"
        assert "device fell over" in (req.error or "")
    deadline = time.perf_counter() + 30
    while eng.healthy and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not eng.healthy and "device fell over" in (eng.error or "")
    assert eng._thread_handle.state == "idle"
    with pytest.raises(DrainingError):
        eng.submit(prompts(1)[0])


def test_kv_gauges_and_refused_features(lm):
    eng = make_engine(lm, kv_pages=10, kv_page_tokens=8)
    snap = eng.registry.snapshot()
    assert snap["serve_kv_pages_total"] == 10
    assert snap["serve_kv_pages_used"] == 0
    # 2 layers x K and V x 2 heads x 16 x 4 bytes a cached position
    assert snap["serve_kv_bytes_per_token"] == 2 * 2 * 2 * 16 * 4
    # Queue A item 5's levers are ported: int8 pages with their scales,
    # the drafter and its pool, the chaos injector; the AOT warm start is
    # refused with the reason it is out of scope.
    int8 = make_engine(lm, kv_pages=10, kv_page_tokens=8, kv_dtype="int8")
    assert int8.registry.snapshot()["serve_kv_bytes_per_token"] == \
        2 * 2 * (2 * 16 + 4)
    spec = make_engine(lm, spec_decode=True, spec_draft_width_mult=1.0)
    assert spec._drafter is lm[1]
    assert spec.drafter_pool_bytes() == spec.kv_pool_bytes()
    assert make_engine(lm, chaos="kill@tokens=1").chaos is not None
    with pytest.raises(NotImplementedError, match="out of scope"):
        ServeConfig(aot_cache="x")
