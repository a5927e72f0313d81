"""The port's shared prefix store (``tpunet_torch.utils.fsatomic`` and
``tpunet_torch.serve.prefixcache.store``, copies of tpunet's) and the
engine's spill and warm start, on the CPU.

``publish_bytes``' first writer wins (sequential and from racing
threads, no tmp file left behind); the store's round trip (depth order,
its own digest only, a torn file skipped; the digest sha256 of sorted
JSON as tpunet's ``AotProgramStore.digest``, scoped by the model and kv
levers and the runtime); then tpunet's two-engine warm start
(tests/test_serve_paged.py:477-517) in the compute-dtype, bf16 and int8
pools: the first engine spills its prefix pages write-through, a fresh
engine on the same directory adopts them when it starts, prefills only
the suffix of a shared-prefix prompt, and gives generate's greedy
tokens; and a store holding foreign, torn and orphan entries beside good
ones, which the warm start skips rather than dying.
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

from tpunet.utils.cache import AotProgramStore
from tpunet_torch.config import ModelConfig, ServeConfig
from tpunet_torch.models.lm import generate
from tpunet_torch.serve import Engine
from tpunet_torch.serve.prefixcache import (ROOT, PrefixStore,
                                            build_prefix_store)
from tpunet_torch.serve.prefixcache.store import digest
from tpunet_torch.utils import fsatomic

from _torch_port import LM, lm_params, port_lm

TINY = dict(vocab_size=31, max_seq_len=48)
VOCAB = TINY["vocab_size"]
MODEL_CFG = ModelConfig(**dict(LM, **TINY))


@pytest.fixture(scope="module")
def lm():
    return port_lm(lm_params(0, **TINY), "dense", **TINY)


def test_publish_bytes_first_writer_wins(tmp_path):
    path = str(tmp_path / "sub" / "entry.pfx")
    assert fsatomic.publish_bytes(path, b"first")
    assert fsatomic.publish_bytes(path, b"second")
    assert open(path, "rb").read() == b"first"
    racers = [threading.Thread(target=fsatomic.publish_bytes,
                               args=(str(tmp_path / "race.pfx"),
                                     f"writer {i}".encode()))
              for i in range(8)]
    for t in racers:
        t.start()
    for t in racers:
        t.join()
    assert open(tmp_path / "race.pfx", "rb").read().startswith(b"writer ")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_store_roundtrip_depth_order_and_scope(tmp_path):
    parts = {"model": {"hidden": 32}, "kv_dtype": "int8"}
    assert digest(parts) == AotProgramStore.digest(parts)
    store = PrefixStore(str(tmp_path), "aaaa")
    rows = [np.arange(8, dtype=np.int8).reshape(2, 4)]
    assert store.save("c2", "c1", 1, rows)
    assert store.save("c1", ROOT, 0, rows)
    assert store.exists("c1") and not store.exists("c3")
    PrefixStore(str(tmp_path), "bbbb").save("x", ROOT, 0, rows)
    (tmp_path / "aaaa-torn.pfx").write_bytes(pickle.dumps({"x": 1})[:5])
    got = list(store.load_all())
    assert [(e["digest"], e["depth"]) for e in got] == [("c1", 0), ("c2", 1)]
    np.testing.assert_array_equal(got[1]["rows"][0], rows[0])
    assert [e["digest"] for e in store.load_all(limit=1)] == ["c1"]
    cfg = ServeConfig()
    base = build_prefix_store(str(tmp_path), MODEL_CFG, cfg, device="cpu")
    assert base.store_digest == build_prefix_store(
        str(tmp_path), MODEL_CFG, cfg, device="cpu").store_digest
    for other in (build_prefix_store(str(tmp_path), MODEL_CFG,
                                     ServeConfig(kv_dtype="int8"), "cpu"),
                  build_prefix_store(str(tmp_path), MODEL_CFG,
                                     ServeConfig(kv_page_tokens=8), "cpu"),
                  build_prefix_store(str(tmp_path), ModelConfig(
                      **dict(LM, **TINY, vit_depth=3)), cfg, "cpu")):
        assert other.store_digest != base.store_digest


def shared_prompts():
    rng = np.random.default_rng(21)
    shared = rng.integers(0, VOCAB, size=8).astype(np.int32)
    return shared, [np.concatenate([shared, rng.integers(
        0, VOCAB, size=k).astype(np.int32)]) for k in (3, 2)]


def store_cfg(kv_dtype):
    return ServeConfig(slots=2, queue_max=8, prefill_buckets=(16,),
                       default_max_new_tokens=6, emit_every_s=0.0,
                       kv_pages=12, kv_page_tokens=4, kv_dtype=kv_dtype)


def solo_greedy(lm, prompt, n):
    return generate(lm, torch.from_numpy(prompt.astype(np.int64))[None],
                    n)[0, len(prompt):].tolist()


@pytest.mark.parametrize("kv_dtype", ["auto", "bf16", "int8"])
def test_prefix_spill_and_warm_start_roundtrip(tmp_path, lm, kv_dtype):
    cfg = store_cfg(kv_dtype)
    store = build_prefix_store(str(tmp_path), MODEL_CFG, cfg, device="cpu")
    _, (p1, p2) = shared_prompts()
    eng = Engine(lm, cfg, prefix_store=store).start()
    try:
        out1 = eng.submit(p1, max_new_tokens=5).result(timeout=120)
    finally:
        eng.stop()
    assert eng.registry.snapshot()["serve_prefix_spills_total"] == 2
    assert len([f for f in tmp_path.iterdir() if f.suffix == ".pfx"]) == 2
    eng2 = Engine(lm, cfg, prefix_store=store).start()
    try:
        assert eng2.registry.snapshot()["serve_prefix_warm_loads_total"] == 2
        out2 = eng2.submit(p2, max_new_tokens=5).result(timeout=120)
        # a cold engine on the same prompts, for the same tokens
        cold = Engine(lm, cfg).start()
        try:
            want2 = cold.submit(p2, max_new_tokens=5).result(timeout=120)
        finally:
            cold.stop()
    finally:
        eng2.stop()
    assert out2 == want2
    if kv_dtype == "auto":
        assert out1 == solo_greedy(lm, p1, 5)
        assert out2 == solo_greedy(lm, p2, 5)
    snap2 = eng2.registry.snapshot()
    assert snap2["serve_prefix_hits_total"] >= 1
    assert snap2["serve_prefix_hit_tokens_total"] >= 8
    # the warmed replica never prefilled the shared prefix at all
    assert snap2["serve_prefill_tokens_total"] == p2.size - 8
    # nothing re-spilled: the pages it adopted are the store's
    assert snap2["serve_prefix_spills_total"] == 0


def test_foreign_torn_and_orphan_entries_are_skipped(tmp_path, lm):
    """One good page among bad entries under the engine's own digest: a
    wrong page shape, a wrong dtype, a missing leaf, a torn pickle, and
    an orphan whose parent is not in the store. The engine starts, adopts
    the good page alone, and still serves generate's tokens."""
    cfg = store_cfg("auto")
    store = build_prefix_store(str(tmp_path), MODEL_CFG, cfg, device="cpu")
    shared, (p1, _) = shared_prompts()
    eng = Engine(lm, cfg, prefix_store=store).start()
    try:
        eng.submit(p1, max_new_tokens=2).result(timeout=120)
    finally:
        eng.stop()
    entries = {e["depth"]: e for e in store.load_all()}
    for f in tmp_path.glob("*.pfx"):
        if entries[1]["digest"] in f.name:
            f.unlink()                      # keep the depth-0 page only
    good = entries[0]["rows"]
    store.save("wrong-shape", ROOT, 0, [r[:2] for r in good])
    store.save("wrong-dtype", ROOT, 0, [r.astype(np.float64) for r in good])
    store.save("missing-leaf", ROOT, 0, good[:-1])
    store.save("orphan", "no-such-parent", 1, good)
    with open(store._path("torn"), "wb") as f:
        f.write(pickle.dumps({"digest": "torn", "rows": good})[:40])
    eng2 = Engine(lm, cfg, prefix_store=store).start()
    try:
        assert eng2.registry.snapshot()["serve_prefix_warm_loads_total"] == 1
        assert eng2._prefix.get(entries[0]["digest"]) is not None
        out = eng2.submit(p1, max_new_tokens=5).result(timeout=120)
    finally:
        eng2.stop()
    assert out == solo_greedy(lm, p1, 5)
    assert eng2.registry.snapshot()["serve_prefill_tokens_total"] == \
        p1.size - 4
