"""Tensor-parallel generation and serving of the port (``--mesh-model``
on ``infer.generate`` and ``tpunet_torch.serve``) against tpunet, on the
CPU.

The LM at hidden 64, 4 heads of 16, 2 blocks, vocab 64, float32, with
tpunet's weights redrawn from numpy (``_torch_port.lm_params``). A gang
of 2 gloo ranks (``tests/_torch_shard_worker.py`` cases ``tp_generate``,
``tp_int8``, ``tp_engine``) at data 1 x model 2:

- ``load_lm`` cuts each checkpoint to the rank's Megatron shard (half
  the qkv rows, a cache of 2 heads) and ``generate`` gives tpunet's
  one-device greedy tokens through the KV cache and without it, for
  ``lm``, for tpunet's stacked ``lm_pp`` tree of the same weights, and
  for an MoE LM (4 experts, 2 a rank, capacity 4 so nothing drops);
  sampled streams agree between the ranks (each rank draws from its
  own generator; the first rank's choice is broadcast).
- ``quantize_kv_rows`` on each rank's heads, its absmax taken over the
  group, gives one process's int8 codes and scales to the bit once the
  codes are gathered over the heads (and tpunet's).
- The engine over the shard, rank 0 serving 8 requests (a shared
  prefix, a page-aligned prompt twice: prefix hits and a COW) and rank
  1 following its op stream: greedy tokens equal to the one-rank
  engine's and to tpunet's ``Engine`` with the paged pool and the prefix
  cache, the dense pool, the host sampler, int8 pages (against tpunet's
  int8 engine), a pool small enough to preempt, K-4 self-speculation
  and a half-width drafter; the pool holds half the bytes a token. The
  pages a TP replica spills hold whole rows, within float32 rounding of
  a one-card replica's; and a one-card replica's spilled pages (bf16
  and int8) written through a TP replica's warm start (each rank its
  heads) read back through the heads' all-gather to the same bytes.

Then the CLIs as 2 processes a run (``RANK``/``WORLD_SIZE`` as torchrun
sets them): the generate CLI's rank 0 prints the one-process CLI's line
and rank 1 nothing; the server answers a request, and a SIGTERM to both
ranks drains them with exit 0; a killed follower turns rank 0's
``/healthz`` to 503 "unhealthy" within ``--tp-timeout-s``, and rank 0
ends without a hang. Indivisible heads exit 2 in both CLIs.
"""

import json
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gang
import _torch_threads
from _torch_port import jax_lm, lm_params, port_lm
from tpunet.config import ServeConfig as JaxServeConfig
from tpunet.models.lm import generate as jax_generate
from tpunet.models.vit import _quantize_kv_rows as jax_quantize
from tpunet.serve import Engine as JaxEngine
from tpunet_torch.config import ModelConfig, ServeConfig
from tpunet_torch.models.convert import lm_params_to_jax
from tpunet_torch.models.vit import quantize_kv_rows
from tpunet_torch.serve import Engine
from tpunet_torch.serve.prefixcache import build_prefix_store

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
TP = dict(vit_hidden=64, vit_depth=2, vit_heads=4, vocab_size=64,
          max_seq_len=48)
MOE = dict(moe_experts=4, moe_capacity_factor=4.0)
# The worker's configuration (tests/_torch_shard_worker.py TP_LM): the
# prefix stores are scoped by it.
LM_CFG = ModelConfig(name="lm", dtype="float32", dropout_rate=0.0, **TP)
GEN_NEW = 8
NEW = 6
PROMPT = [[7, 1, 4, 33], [2, 2, 9, 60]]
BASE = dict(slots=4, queue_max=16, prefill_buckets=(8, 16),
            kv_page_tokens=4, emit_every_s=0.0)
ENGINES = {
    "paged_prefix": dict(BASE, store="store_tp"),
    "dense": dict(BASE, paged_kv=False),
    "host_sampler": dict(BASE, device_sampling=False),
    "int8": dict(BASE, kv_dtype="int8", store="store_tp_int8"),
    "preempt": dict(BASE, kv_pages=10),
    "spec": dict(BASE, spec_decode=True, spec_k=4,
                 spec_draft_width_mult=1.0),
    "spec_half": dict(BASE, spec_decode=True, spec_k=4,
                      spec_draft_width_mult=0.5),
    "warm": dict(BASE, store="store_1"),
    "warm_int8": dict(BASE, kv_dtype="int8", store="store_1_int8"),
}
SERVE_FLAGS = ["--device", "cpu", "--vit-hidden",
               "64", "--vit-depth", "2", "--vit-heads", "4", "--vocab-size",
               "64", "--max-seq-len", "48", "--slots", "4",
               "--prefill-buckets", "8,16", "--emit-every-s", "0"]


def prompts():
    """8 requests: an 8-token shared prefix (two pages of 4) with 4
    suffixes, a page-aligned 8-token prompt twice (the second a full
    prefix hit: a copy on write) and 2 short prompts, in an order that
    admits the repeats after their first's prefill."""
    rng = np.random.default_rng(13)
    shared = rng.integers(0, TP["vocab_size"], 8)
    s = [np.concatenate([shared, rng.integers(0, TP["vocab_size"], k)])
         for k in (3, 2, 5, 1)]
    r = rng.integers(0, TP["vocab_size"], 8)
    short = [rng.integers(0, TP["vocab_size"], k) for k in (3, 5)]
    return [a.astype(np.int32) for a in
            (s[0], r, short[0], s[1], s[2], r.copy(), short[1], s[3])]


def one_rank_engine(model, kw, d):
    """The one-rank engine of ``kw`` over ``model``: its greedy tokens of
    :func:`prompts` and itself (stopped)."""
    kw = dict(kw)
    store = kw.pop("store", None)
    cfg = ServeConfig(**kw)
    eng = Engine(model, cfg, prefix_store=store and build_prefix_store(
        str(d / store), LM_CFG, cfg, device="cpu")).start()
    try:
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts()]
        return [r.result(timeout=120) for r in reqs], eng
    finally:
        eng.stop()


def jax_engine_tokens(params, **kw):
    eng = JaxEngine(jax_lm(**TP), {"params": params}, JaxServeConfig(
        slots=4, queue_max=16, prefill_buckets=(8, 16), emit_every_s=0.0,
        **kw)).start()
    try:
        reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts()]
        return [r.result(timeout=300) for r in reqs]
    finally:
        eng.stop()


def _redraw_experts(params, rng):
    """Nonzero expert biases and a router that prefers some experts (as
    tests/test_torch_moe.py draws them)."""
    for node in params.values():
        if isinstance(node, dict) and "moe" in node:
            moe = node["moe"]
            moe["bi"] = rng.normal(0, 0.1, moe["bi"].shape).astype(np.float32)
            moe["bo"] = rng.normal(0, 0.1, moe["bo"].shape).astype(np.float32)
            moe["router"]["kernel"] = rng.normal(
                0, 0.3, moe["router"]["kernel"].shape).astype(np.float32)
    return params


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _save(params, d: Path) -> None:
    from tpunet_torch.models.convert import lm_state_dict_from_jax
    d.mkdir()
    torch.save(lm_state_dict_from_jax(params), d / "best.pth")


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    params = lm_params(0, **TP)
    moe_params = _redraw_experts(lm_params(3, **TP, **MOE),
                                 np.random.default_rng(3))
    _save(params, d / "ck_lm")
    _save(moe_params, d / "ck_moe")
    # tpunet's lm_pp checkpoint: its stacked tree of the same weights.
    (d / "ck_lmpp").mkdir()
    stacked = lm_params_to_jax(torch.load(d / "ck_lm" / "best.pth"),
                               stacked=True)
    assert "blocks_qkv_k" in stacked
    torch.save(_torch_tree(stacked), d / "ck_lmpp" / "best.pth")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(40, 4, 16)).astype(np.float32)
    x[3, 2, 7] = 40.0            # an outlier in rank 1's heads
    x[11] *= 1e-3
    x[17] = 0.0                  # an all-zero row (scale 1)
    np.savez(d / "tp_int8.npz", x=x)
    # The one-card replicas' spills, which the TP replicas warm from.
    model = port_lm(params, "dense", **TP)
    one = {}
    for name, store in (("paged_prefix", "store_1"),
                        ("int8", "store_1_int8")):
        one[name] = one_rank_engine(model, dict(ENGINES[name], store=store),
                                    d)
    (d / "tp_serve.json").write_text(json.dumps(dict(
        prompt=PROMPT, generate_new=GEN_NEW,
        generate={"lm": dict(model="lm", dir="ck_lm", moe={}),
                  "lm_pp": dict(model="lm_pp", dir="ck_lmpp", moe={}),
                  "moe": dict(model="lm", dir="ck_moe", moe=MOE)},
        prompts=[p.tolist() for p in prompts()], new=NEW,
        engines={k: {kk: list(vv) if isinstance(vv, tuple) else vv
                     for kk, vv in v.items()} for k, v in ENGINES.items()})))
    gang = _torch_gang.start(d, WORLD, ["tp_generate", "tp_int8",
                                        "tp_engine"])
    # Meanwhile: tpunet's references and the other one-rank engines.
    prompt = jnp.asarray(PROMPT, jnp.int32)
    want_gen = {
        "lm": np.asarray(jax_generate(jax_lm(**TP), {"params": params},
                                      prompt, n_new=GEN_NEW)),
        "moe": np.asarray(jax_generate(jax_lm(**TP, **MOE),
                                       {"params": moe_params}, prompt,
                                       n_new=GEN_NEW))}
    want_gen["lm_pp"] = want_gen["lm"]
    for name, kw in ENGINES.items():
        if name not in one and not name.startswith("warm"):
            one[name] = one_rank_engine(model, dict(kw, store=None), d)
    jax_tokens = {"auto": jax_engine_tokens(params),
                  "int8": jax_engine_tokens(params, kv_dtype="int8")}
    _torch_gang.wait(d, WORLD, gang)
    ranks = {case: [torch.load(d / f"{case}_rank{r}.pt", weights_only=False)
                    for r in range(WORLD)]
             for case in ("tp_generate", "tp_int8", "tp_engine")}
    return dict(d=d, x=x, want_gen=want_gen, one=one, jax=jax_tokens,
                ranks=ranks)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lm", "lm_pp", "moe"])
def test_tp_generate_equals_tpunets_tokens(tp, name):
    want = tp["want_gen"][name]
    for rank in tp["ranks"]["tp_generate"]:
        row = rank[name]
        np.testing.assert_array_equal(row["cache"].numpy(), want)
        np.testing.assert_array_equal(row["nocache"].numpy(), want)
        # the rank's shard: 2 of 4 heads of each of q, k and v
        assert row["qkv_rows"] == 3 * 64 // WORLD
        assert row["cache_heads"] == 4 // WORLD


def test_tp_sampled_stream_is_the_first_ranks(tp):
    r0, r1 = tp["ranks"]["tp_generate"]
    for name in ("lm", "moe"):
        assert torch.equal(r0[name]["sampled"], r1[name]["sampled"])
        assert not torch.equal(r0[name]["sampled"], r0[name]["cache"])


def test_tp_int8_codes_and_scales_equal_one_rank(tp):
    x = torch.from_numpy(tp["x"])
    codes, scales = quantize_kv_rows(x)
    for rank in tp["ranks"]["tp_int8"]:
        assert torch.equal(rank["codes"], codes)
        assert torch.equal(rank["scales"], scales)
    jc, js = jax_quantize(jnp.asarray(tp["x"]))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in ENGINES
                                  if not n.startswith("warm")])
def test_tp_engine_greedy_equals_one_rank_and_tpunet(tp, name):
    row = tp["ranks"]["tp_engine"][0][name]
    one_tokens, one = tp["one"][name]
    assert row["tokens"] == one_tokens
    ref = tp["jax"]["int8" if name == "int8" else "auto"]
    assert row["tokens"] == ref
    # each rank's pool: half the heads' bytes a token (int8 pages' row
    # scales whole on every rank)
    share = sum(t.numel() * t.element_size() / (WORLD if t.dim() > 1 else 1)
                for t in one._cache.leaves()) / one.kv_pool_bytes()
    for rank in tp["ranks"]["tp_engine"]:
        assert rank[name]["kv_bytes_per_token"] == pytest.approx(
            one.kv_bytes_per_token() * share, abs=0.01)
    assert share == (0.5 if name != "int8" else (16 * 2 + 4) / (16 * 4 + 4))
    snap = row["snapshot"]
    ops = row["ops"]
    assert ops["step"] > 0 and ops["stop"] == 1
    if name in ("paged_prefix", "int8"):
        assert snap["serve_prefix_hits_total"] > 0
        assert snap["serve_prefix_cow_total"] > 0
        assert ops["copy_page"] == snap["serve_prefix_cow_total"]
        assert ops["read_page"] == snap["serve_prefix_spills_total"] > 0
    if name == "preempt":
        assert snap["serve_kv_preemptions_total"] > 0
    if name.startswith("spec"):
        assert ops["draft_burst"] == ops["verify"] > 0
        assert ops["draft_prefill"] > 0
        # a verify op scores every bursting slot
        assert ops["verify"] <= snap["serve_spec_verify_steps_total"]
    if name == "spec":
        assert snap["serve_spec_acceptance_rate"] == 1.0


def _store(d, name, kv_dtype="auto"):
    cfg = ServeConfig(**dict(BASE, kv_dtype=kv_dtype))
    return {e["digest"]: e for e in build_prefix_store(
        str(d / name), LM_CFG, cfg, device="cpu").load_all()}


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_tp_spilled_pages_hold_a_one_card_replicas_rows(tp, kv_dtype):
    suffix = "_int8" if kv_dtype == "int8" else ""
    mine = _store(tp["d"], "store_tp" + suffix, kv_dtype)
    theirs = _store(tp["d"], "store_1" + suffix, kv_dtype)
    assert mine and mine.keys() == theirs.keys()
    for digest, entry in mine.items():
        for got, want in zip(entry["rows"], theirs[digest]["rows"]):
            assert got.shape == want.shape and got.dtype == want.dtype
            if kv_dtype == "int8" and got.dtype == np.int8:
                # codes of float32 K/V that round differently across a .5
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["warm", "warm_int8"])
def test_tp_warm_start_reads_back_the_stores_bytes(tp, name):
    kv_dtype = "int8" if name.endswith("int8") else "auto"
    store = _store(tp["d"], ENGINES[name]["store"], kv_dtype)
    pages = tp["ranks"]["tp_engine"][0][name]["pages"]
    assert store and pages.keys() == store.keys()
    for digest, rows in pages.items():
        want = store[digest]["rows"]
        assert len(rows) == len(want)
        for got, w in zip(rows, want):
            assert got.dtype == w.dtype and np.array_equal(got, w)


# ---------------------------------------------------------------------------
# the CLIs, one process a rank
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(tmp_path, module, flags, tag):
    """The 2 ranks of ``python -m module flags`` with torchrun's
    variables; (process, stdout path, stderr path) each."""
    env = _torch_threads.child_env(
        PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD))
    out = []
    for r in range(WORLD):
        o, e = tmp_path / f"{tag}{r}.out", tmp_path / f"{tag}{r}.err"
        out.append((subprocess.Popen(
            [sys.executable, "-u", "-m", module, *flags],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
            stdout=open(o, "w"), stderr=open(e, "w")), o, e))
    return out


def _kill_all(ranks):
    for p, _, _ in ranks:
        if p.poll() is None:
            p.kill()
            p.wait()


def _listening(ranks, timeout=120.0) -> str:
    """Rank 0's base URL, once it says it listens."""
    deadline = time.monotonic() + timeout
    p, out, err = ranks[0]
    while time.monotonic() < deadline:
        for line in out.read_text().splitlines():
            if "listening on " in line:
                return line.split("listening on ")[1].split()[0]
        assert p.poll() is None, err.read_text()[-3000:]
        time.sleep(0.1)
    raise AssertionError("rank 0 never listened")


def _post(base, body, timeout=60):
    req = urllib.request.Request(base + "/v1/generate",
                                 json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _health(base):
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_tp_generate_cli_prints_the_one_process_line(tp, tmp_path):
    flags = ["--checkpoint-dir", str(tp["d"] / "ck_lm"), "--device", "cpu",
             "--vit-hidden",
             "64", "--vit-depth", "2", "--vit-heads", "4", "--vocab-size",
             "64", "--max-seq-len", "48", "--prompt", "5 9 2", "--tokens",
             "10"]
    want = subprocess.run(
        [sys.executable, "-m", "tpunet_torch.infer.generate", *flags],
        cwd=ROOT, env=_torch_threads.child_env(), capture_output=True,
        text=True, timeout=120)
    assert want.returncode == 0, want.stderr
    ranks = _ranks(tmp_path, "tpunet_torch.infer.generate",
                   flags + ["--mesh-model", "2"], "gen")
    try:
        for p, _, err in ranks:
            assert p.wait(timeout=120) == 0, err.read_text()[-3000:]
    finally:
        _kill_all(ranks)
    assert ranks[0][1].read_text() == want.stdout
    assert len(want.stdout.split()) == 13
    assert ranks[1][1].read_text() == ""


def test_tp_serve_sigterm_drains_every_rank_with_exit_0(tp, tmp_path):
    ranks = _ranks(tmp_path, "tpunet_torch.serve", SERVE_FLAGS + [
        "--checkpoint-dir", str(tp["d"] / "ck_lm"),
        "--port", "0", "--mesh-model", "2", "--metrics-dir",
        str(tmp_path / "m")], "srv")
    try:
        base = _listening(ranks)
        assert _health(base)[0] == 200
        one = _post(base, {"tokens": [5, 9, 2], "max_new_tokens": 8})
        assert len(one["tokens"]) == 8
        # A request in flight when the signal lands finishes whole.
        got = {}
        t = threading.Thread(target=lambda: got.update(_post(
            base, {"tokens": [5, 9, 2], "max_new_tokens": 40})))
        t.start()
        time.sleep(0.3)
        for p, _, _ in ranks:
            p.send_signal(signal.SIGTERM)
        for p, _, err in ranks:
            assert p.wait(timeout=120) == 0, err.read_text()[-3000:]
        t.join(timeout=60)
    finally:
        _kill_all(ranks)
    assert got["finish_reason"] == "length" and len(got["tokens"]) == 40
    assert got["tokens"][:8] == one["tokens"]
    assert "drained (clean)" in ranks[0][1].read_text()
    records = [json.loads(line) for line in
               (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    final = [r for r in records if r.get("kind") == "obs_serve"][-1]
    # the rank's pool: K and V of 2 blocks, 2 of 4 heads of 16 values, in
    # the server's compute dtype (bf16)
    assert final["final"] and final["kv_bytes_per_token"] == 2 * 2 * 2 * 16 * 2


def test_tp_killed_follower_turns_rank0_unhealthy(tp, tmp_path):
    timeout_s = 10
    ranks = _ranks(tmp_path, "tpunet_torch.serve", SERVE_FLAGS + [
        "--checkpoint-dir", str(tp["d"] / "ck_lm"),
        "--port", "0", "--mesh-model", "2", "--tp-timeout-s",
        str(timeout_s), "--metrics-dir", str(tmp_path / "m")], "kill")
    try:
        base = _listening(ranks)
        assert len(_post(base, {"tokens": [5, 9, 2],
                                "max_new_tokens": 4})["tokens"]) == 4
        ranks[1][0].kill()
        ranks[1][0].wait()
        killed = time.monotonic()
        # Probe until rank 0 answers 503 "unhealthy" or its listener
        # closes: its main loop drains a dead engine within 0.5 s, so
        # under load a probe can miss that window.
        seen = None
        while seen is None and time.monotonic() - killed < timeout_s + 20:
            try:
                code, body = _health(base)
            except (urllib.error.URLError, OSError):
                break
            if code == 503 and body["status"] == "unhealthy":
                seen = body
            time.sleep(0.01)
        # rank 0 sees its dead engine and ends on its own: no hang
        assert ranks[0][0].wait(timeout=timeout_s + 60) == 2
        ended = time.monotonic() - killed
    finally:
        _kill_all(ranks)
    said = ranks[0][2].read_text()
    assert "engine unhealthy: " in said, said[-3000:]
    assert ended < timeout_s + 60
    if seen is not None:
        assert seen["error"] in said


@pytest.mark.parametrize("module", ["tpunet_torch.infer.generate",
                                    "tpunet_torch.serve"])
def test_tp_indivisible_heads_exit_2(module):
    out = subprocess.run(
        [sys.executable, "-m", module, "--checkpoint-dir", "", "--device",
         "cpu", "--vit-hidden", "48", "--vit-heads", "3", "--mesh-model",
         "2"], cwd=ROOT, env=_torch_threads.child_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "--vit-heads 3 not divisible" in out.stderr
