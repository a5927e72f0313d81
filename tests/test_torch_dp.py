"""Data parallelism of the port against tpunet's single-process math, on
the CPU: gloo process groups of 2 ranks and of 1, each rank a subprocess
(tests/_torch_dp_worker.py, which imports no JAX) with its stderr in a
file and a timeout, killed on any failure.

- (a) A 2-rank train-mode forward/backward on 4 + 4 images against
  tpunet's single-process step on the same 8 images, the inputs and
  weights of tests/test_torch_train.py's ``train_pass`` (seed 2, dropout
  0, float32), with ``fused_ir`` on and off, at that file's tolerances:
  logits (the ranks' concatenated) rtol/atol 1e-3, loss 1e-4, every
  gradient within 1e-3 of the largest, running statistics rtol 1e-3 /
  atol 1e-4. With rank-local BN the 1x1 tail would reduce over 4
  samples instead of 8 and fail.
- (b) ``--preset distributed`` at world 1 over gloo is bit-equal to
  ``single``: the parameters after the epoch's 3 steps, and the epoch
  line.
- (c) A 2-rank Trainer epoch equals the 1-rank epoch on the same global
  batch: the losses within 1e-4 relative; both ranks hold the same
  metrics and the same parameters to the bit; only rank 0 writes
  ``metrics.jsonl`` and prints; ``--eval-only`` of its checkpoint.
- (d) Gradient accumulation 1 and 2 at world 1 and 2 against tpunet's
  ``_steps_from_micro`` on the same 8 images (dropout 0, one SGD step).
  The tiny ViT (no BN): every gradient within 1e-5 of the largest, and
  accumulation 2 equals 1. MobileNetV2: the running statistics, updated
  once per microbatch from the global microbatch's statistics, and the
  loss. Its gradients are not compared at accumulation 2: train-mode BN
  at random init amplifies the last bits of its sums, so that two
  summation orders of one batch give gradients percent apart for many
  batches (scripts/torch_train_conditioning.py measures it per image
  seed), and the microbatches of 4 images here are such batches; (a)
  holds the gradients at 8.
- (e) The clip against optax's ``clip_by_global_norm``, above and below
  the threshold.
- (f) A tiny ViT at 2 ranks equals 1 rank at dropout 0.
- (g) Without a group the helpers are the identity.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.train import metrics as JM
from tpunet.train.state import TrainState as JaxTrainState
from tpunet.train.steps import _steps_from_micro
from tpunet_torch.config import ModelConfig, OptimConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import (load_state_dict, state_dict_from_jax,
                                         vit_state_dict_from_jax)
from tpunet_torch.parallel import dist
from tpunet_torch.train.state import TrainState, make_optimizer

from _torch_port import SIZE, WIDTH, train_variables

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dp_worker.py"
N_TRAIN = 8
TIMEOUT_S = 120
VIT = dict(name="vit", vit_patch=4, vit_hidden=32, vit_depth=2, vit_heads=2,
           dtype="float32", dropout_rate=0.0)
# The 1-rank and 2-rank trainer epochs: float32 sums over 8 + 8 rows
# against 16 differ in the last bits, and Adam's first update,
# lr * g / (|g| + eps), moves a parameter whose gradient is rounding
# noise (every project BN's bias: its true gradient is 0) by a full lr
# in the direction those bits pick.
EPOCH_RTOL = 1e-4


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    # One intra-op thread everywhere: a CPU reduction's bits depend on
    # how many threads split it, and (b) compares runs to the bit.
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(d: Path, cmds):
    """Start the commands, stdout and stderr to files in ``d``."""
    procs = []
    for name, cmd in cmds:
        out = open(d / f"{name}.out", "w")
        err = open(d / f"{name}.err", "w")
        procs.append((name, subprocess.Popen(cmd, stdout=out, stderr=err,
                                             env=_env(), cwd=ROOT),
                      out, err))
    return procs


def _wait(d: Path, procs):
    """Wait for every process (each within TIMEOUT_S); kill them all on a
    failure, and raise with the failing one's stderr."""
    try:
        for name, p, out, err in procs:
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} did not finish in "
                                     f"{TIMEOUT_S} s") from None
            assert p.returncode == 0, (
                f"{name} exited {p.returncode}:\n"
                f"{(d / f'{name}.err').read_text()[-3000:]}")
    finally:
        for _, p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs written, the 2-rank and 1-rank gangs and a ``single`` CLI
    run started, tpunet's references computed while they run."""
    d = tmp_path_factory.mktemp("dp")
    params, stats = train_variables(seed=2)
    x = np.random.default_rng(9).standard_normal(
        (N_TRAIN, SIZE, SIZE, 3)).astype(np.float32)
    y = np.arange(N_TRAIN, dtype=np.int64)
    np.savez(d / "inputs.npz", x=x, y=y)
    port = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                        device="cpu")
    assert load_state_dict(port, state_dict_from_jax(params, stats))
    torch.save(port.state_dict(), d / "mnv2.pt")
    jvit, vparams = _jax_vit()
    vit = create_model(ModelConfig(**VIT), device="cpu", image_size=SIZE)
    assert load_state_dict(vit, vit_state_dict_from_jax(vparams))
    torch.save(vit.state_dict(), d / "vit.pt")

    single = [sys.executable, "-m", "tpunet_torch.train", "--preset",
              "single", "--dataset", "synthetic", "--synthetic-size", "48",
              "--image-size", str(SIZE), "--width-mult", str(WIDTH),
              "--dtype", "float32", "--pallas-depthwise", "--epochs", "1",
              "--seed", "1", "--device", "cpu", "--batch-size", "16",
              "--checkpoint-dir", str(d / "ck_single")]
    procs = _start(d, [(f"w{w}_rank{r}", [sys.executable, str(WORKER),
                                          str(d), str(w), str(r)])
                       for w in (2, 1) for r in range(w)]
                   + [("single", single)])
    try:
        refs = _references(params, stats, jvit, vparams, x, y)
    finally:
        _wait(d, procs)
    out = {(w, r): torch.load(d / f"w{w}_rank{r}.pt", weights_only=False)
           for w in (2, 1) for r in range(w)}
    return d, refs, out, vit


def _jax_vit():
    """tpunet's tiny ViT (dense core) and its params as numpy, with the
    LayerNorms, the biases and Flax's zero classifier redrawn, as
    tests/test_torch_vit.py does (a zero classifier has zero gradients
    above it)."""
    model = jax_create_model(JaxModelConfig(attention="dense", **VIT))
    v = jax.jit(lambda key: init_variables(model, key, image_size=SIZE))(
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    v["params"])
    params = jax.tree_util.tree_map(np.array, params)   # writable copies
    rng = np.random.default_rng(0)

    def redraw(tree):
        for node in tree.values():
            if not hasattr(node, "items"):
                continue
            if "scale" in node:
                node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape
                                            ).astype(np.float32)
            if "bias" in node:
                node["bias"] = rng.normal(0.0, 0.1, node["bias"].shape
                                          ).astype(np.float32)
            redraw(node)

    params = _plain(params)
    redraw(params)
    params["classifier"]["kernel"] = rng.normal(
        0.0, 0.5, params["classifier"]["kernel"].shape).astype(np.float32)
    return model, params


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else v
            for k, v in tree.items()}


def _references(params, stats, jvit, vparams, x, y):
    """tpunet on the 8 images: the MobileNetV2 train pass, and one
    SGD(1.0) step of ``_steps_from_micro`` at accumulation 1 and 2 for
    MobileNetV2 and the ViT."""
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH,
                                             dropout_rate=0.0))
    xj, yj = jnp.asarray(x), jnp.asarray(y, jnp.int32)

    def grad_fn_of(model):
        def loss_fn(p, bs, xx, yy):
            logits, mut = model.apply({"params": p, "batch_stats": bs}, xx,
                                      train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, yy).mean()
            return loss, (logits, mut.get("batch_stats", {}))
        return jax.value_and_grad(loss_fn, has_aux=True)

    grad_fn = grad_fn_of(jmodel)
    (jloss, (jlogits, jstats)), jgrads = jax.jit(grad_fn)(params, stats,
                                                          xj, yj)
    refs = {"loss": float(jloss), "logits": np.asarray(jlogits),
            "grads": _torch_tree(jgrads, stats),
            "stats": _torch_tree(params, jstats)}

    for name, model, p0, bs in (("mnv2", jmodel, params, stats),
                                ("vit", jvit, vparams, {})):
        g = grad_fn_of(model)

        def micro(p, bs, apply_fn, xx, yy, rng, g=g):
            (loss, (logits, new_bs)), grads = g(p, bs, xx, yy)
            n = yy.shape[0]
            return grads, new_bs, JM.from_batch(
                loss * n, jnp.sum(jnp.argmax(logits, -1) == yy), n)

        for accum in (1, 2):
            state = JaxTrainState.create(apply_fn=model.apply, params=p0,
                                         tx=optax.sgd(1.0), batch_stats=bs)
            new, m = jax.jit(_steps_from_micro(micro, accum, None))(
                state, xj, yj, jax.random.PRNGKey(0))
            # One SGD(1.0) step: the gradient is the parameters' change.
            delta = jax.tree_util.tree_map(np.subtract, p0,
                                           jax.tree_util.tree_map(
                                               np.asarray, new.params))
            refs[name, accum] = {
                "grads": (_torch_tree(delta, stats) if name == "mnv2"
                          else vit_state_dict_from_jax(delta)),
                "stats": (_torch_tree(p0, new.batch_stats)
                          if name == "mnv2" else {}),
                "metrics": {k: float(v) for k, v in m.items()}}
    return refs


def _torch_tree(params, stats):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               jax.tree_util.tree_map(np.asarray, stats))


def _grads_close(got, want):
    assert len(got) == 158
    gmax = max(float(want[k].abs().max()) for k in got)
    for key, g in got.items():
        err = float((g - want[key]).abs().max())
        assert err <= 1e-3 * gmax, (key, err, gmax)


def _stats_close(got, want):
    assert len(got) == 2 * 52
    for key, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=key)


# -- (a) cross-rank BN against tpunet's global batch -----------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ir", "bn_train"])
def test_two_ranks_match_tpunets_global_batch_step(runs, fused):
    _, refs, out, _ = runs
    r0, r1 = out[2, 0]["bn"][fused], out[2, 1]["bn"][fused]
    logits = torch.cat([r0["logits"], r1["logits"]]).numpy()
    np.testing.assert_allclose(logits, refs["logits"], rtol=1e-3, atol=1e-3)
    assert abs((r0["loss"] + r1["loss"]) / 2 - refs["loss"]) < 1e-4
    _grads_close(r0["grads"], refs["grads"])
    _stats_close(r0["stats"], refs["stats"])
    for key in r0["grads"]:        # one all-reduced buffer on both ranks
        assert torch.equal(r0["grads"][key], r1["grads"][key]), key
    for key in r0["stats"]:        # running statistics of the global batch
        assert torch.equal(r0["stats"][key], r1["stats"][key]), key


def test_a_step_issues_105_collectives_a_rank(runs):
    """52 BN reductions forward, 52 backward, one gradient buffer; the
    two models of the bn case take 2 x 105."""
    _, _, out, _ = runs
    assert out[2, 0]["bn_collectives"] == out[2, 1]["bn_collectives"] == 210
    assert out[1, 0]["bn_collectives"] == 210


# -- (b), (c) the trainer ----------------------------------------------------


def _epoch_line(text):
    found = re.findall(r"^Epoch 1/1 Time: [\d.]+s (.*)$", text, re.M)
    assert len(found) == 1, text
    return found[0]


def test_distributed_world_one_is_bit_equal_to_single(runs):
    d, _, out, _ = runs
    single = torch.load(d / "ck_single" / "state.pt", weights_only=True)
    one = torch.load(d / "ck_w1" / "state.pt", weights_only=True)
    assert single["global_step"] == one["global_step"] == 3
    for key, v in single["model"].items():
        assert torch.equal(v, one["model"][key]), key
    assert _epoch_line((d / "single.out").read_text()) == _epoch_line(
        (d / "w1_rank0.out").read_text())
    assert "Processes: 1 (gloo), global batch 16" in (
        d / "w1_rank0.out").read_text()


def test_two_rank_epoch_equals_one_rank_epoch(runs):
    d, _, out, _ = runs
    one = out[1, 0]["trainer"]["history"][0]
    h0 = out[2, 0]["trainer"]["history"][0]
    h1 = out[2, 1]["trainer"]["history"][0]
    keys = ("step", "train_loss", "train_accuracy", "test_loss",
            "test_accuracy")
    assert {k: h0[k] for k in keys} == {k: h1[k] for k in keys}
    assert (h0["process_index"], h1["process_index"]) == (0, 1)
    assert h0["run_id"] == h1["run_id"]
    assert h0["step"] == one["step"] == 3
    for k in ("train_loss", "test_loss"):
        assert h0[k] == pytest.approx(one[k], rel=EPOCH_RTOL), k
    p0, p1 = out[2, 0]["trainer"]["params"], out[2, 1]["trainer"]["params"]
    for key in p0:
        assert torch.equal(p0[key], p1[key]), key


def test_only_rank_zero_writes_and_prints(runs):
    d, _, out, _ = runs
    lines = (d / "ck_w2" / "metrics.jsonl").read_text().splitlines()
    plain = [line for line in lines if '"kind"' not in line]
    assert len(plain) == 1
    assert all('"process_index": 0' in line for line in lines)
    assert (d / "ck_w2" / "best.pth").exists()
    r0, r1 = (d / "w2_rank0.out").read_text(), (d / "w2_rank1.out").read_text()
    assert "Processes: 2 (gloo), global batch 16" in r0
    _epoch_line(r0)
    assert "Epoch" not in r1 and "Eval:" not in r1
    acc = out[2, 0]["trainer"]["history"][0]["test_accuracy"]
    found = re.search(r"Eval: Test Loss: \S+ Test Acc: (\S+)", r0)
    assert found and float(found.group(1)) == pytest.approx(acc, abs=5e-5)


# -- (d) gradient accumulation ----------------------------------------------


def _metrics_close(out, world, name, accum, want):
    m = {k: sum(out[world, r]["accum"][name, accum]["metrics"][k]
                for r in range(world)) for k in want}
    assert m["count"] == want["count"] == N_TRAIN
    assert m["correct"] == want["correct"]
    assert m["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-4)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("accum", [1, 2])
def test_grad_accum_vit_matches_tpunets_steps_from_micro(runs, world, accum):
    _, refs, out, _ = runs
    want = refs["vit", accum]
    got = out[world, 0]["accum"]["vit", accum]["grads"]
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for key, g in want["grads"].items():
        assert float((got[key] - g).abs().max()) <= 1e-5 * gmax, key
        one = out[world, 0]["accum"]["vit", 1]["grads"][key]
        assert float((got[key] - one).abs().max()) <= 1e-5 * gmax, key
    _metrics_close(out, world, "vit", accum, want["metrics"])


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("accum", [1, 2])
def test_grad_accum_bn_matches_tpunets_steps_from_micro(runs, world, accum):
    _, refs, out, _ = runs
    want = refs["mnv2", accum]
    got = out[world, 0]["accum"]["mnv2", accum]
    _stats_close(got["stats"], want["stats"])
    _metrics_close(out, world, "mnv2", accum, want["metrics"])
    if accum == 1:
        _grads_close(got["grads"], want["grads"])


# -- (e) clip-norm -----------------------------------------------------------


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["above", "below"])
def test_clip_norm_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    norm = np.sqrt(sum(float((a * a).sum()) for a in g))
    assert (norm >= max_norm) == (max_norm == 0.5)
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.sgd(0.1))
    jp = [jnp.asarray(a) for a in p0]
    upd, _ = tx.update([jnp.asarray(a) for a in g], tx.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    cfg = OptimConfig(name="sgd", learning_rate=0.1, clip_norm=max_norm)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    for p, a in zip(tp, g):
        p.grad = torch.from_numpy(a.copy())
    state = TrainState(torch.nn.ParameterList(tp), make_optimizer(tp, cfg),
                       lambda t: 0.1, clip_norm=max_norm)
    state.apply_gradients()
    for p, w in zip(tp, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


# -- (f) ViT -------------------------------------------------------------------


def test_vit_two_ranks_equal_one(runs):
    d, _, out, vit = runs
    inputs = np.load(d / "inputs.npz")
    x, y = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"])
    loss = F.cross_entropy(vit(x.permute(0, 3, 1, 2), train=True,
                               generator=torch.Generator()), y)
    loss.backward()
    want = {k: p.grad for k, p in vit.named_parameters()}
    r0, r1 = (out[2, r]["accum"]["vit", 1] for r in range(2))
    got = (r0["metrics"]["loss_sum"] + r1["metrics"]["loss_sum"]) / N_TRAIN
    assert got == pytest.approx(loss.item(), rel=1e-5)
    gmax = max(float(g.abs().max()) for g in want.values())
    assert gmax > 0
    for key, g in want.items():
        assert float((r0["grads"][key] - g).abs().max()) <= 1e-5 * gmax, key
        assert torch.equal(r0["grads"][key], r1["grads"][key]), key


# -- (g) no group ------------------------------------------------------------


def test_helpers_are_the_identity_without_a_group():
    assert not dist.is_initialized()
    t = torch.randn(3, requires_grad=True)
    calls = dist.all_reduce.calls
    assert dist.all_reduce_sum(t) is t
    u = torch.randn(2)
    assert dist.all_reduce(u) is u
    assert dist.all_reduce.calls == calls
    assert (dist.process_index(), dist.process_count()) == (0, 1)
    assert dist.local_device("cpu") == torch.device("cpu")
    dist.sync_hosts("nothing")
    dist.destroy()
