"""Parity of the port's LM training (``make_lm_train_step``,
``make_lm_eval_step``, the Trainer's LM branch) with tpunet's, on the CPU.

The tiny float32 LM of ``_torch_port.LM`` (dropout 0), tpunet's weights
carried across; 8 token rows of 48, and for packed rows [8, 48] segment
ids (documents of 1-19 tokens, then a padding tail of id 0):

- one train step's loss against tpunet's micro math (the CE mean, or
  for packed rows the CE summed over the valid targets over their
  count, through ``jax.value_and_grad``): 1e-5 relative, every gradient
  within 1e-5 of the largest; its (loss, correct, count) sums against
  tpunet's ``make_lm_train_step``: the loss to 1e-5 relative, correct
  and count exact;
- packed ``grad_accum=2`` against the accum-1 step: gradients within
  1e-6 of the largest, and the sums against tpunet's accum-2 step;
- the eval sums against tpunet's ``make_lm_eval_step`` on a batch with
  padded rows;
- 2 gloo ranks on packed rows (``tests/_torch_dp_worker.py ... lm``)
  against the world-1 step on the same global batch: the loss to 1e-6,
  gradients within 1e-5 of the largest (the ranks' valid counts differ,
  so each rank must divide by the global count);
- the training CLI for one epoch on ``synthetic_lm`` and on packed
  ``text_lm`` (``best.pth`` evaluates to the epoch's accuracy,
  ``--eval-only`` prints it), and a resumed run equal to an
  uninterrupted one to the bit.
"""

import json
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

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import OptimConfig as JaxOptimConfig
from tpunet.train.state import TrainState as JaxTrainState
from tpunet.train.steps import _ce_loss as jax_ce_loss
from tpunet.train.steps import _packed_target_weights as jax_weights
from tpunet.train.steps import make_lm_eval_step as jax_lm_eval_step
from tpunet.train.steps import make_lm_train_step as jax_lm_train_step
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 OptimConfig, TrainConfig)
from tpunet_torch.models.convert import load_state_dict_file
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer
from tpunet_torch.train.state import TrainState, make_optimizer
from tpunet_torch.train.steps import fit_lm_batch, make_lm_eval_step

from _torch_port import LM, jax_lm, lm_params, packed_segments, port_lm
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_dp_worker.py"
B, T = 8, 48
CLI_LM = ["--preset", "serial", "--model", "lm", "--vit-hidden", "32",
          "--vit-depth", "2", "--vit-heads", "2", "--seq-len", "32",
          "--batch-size", "8", "--dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def setup():
    params = lm_params(3)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, LM["vocab_size"], (B, T), dtype=np.int32)
    return params, tokens, packed_segments(rng, B, T)


def _jax_cfg():
    return JaxModelConfig(attention="dense", **LM)


def _jax_state(params):
    return JaxTrainState.create(apply_fn=jax_lm().apply, params=params,
                                tx=optax.sgd(1.0), batch_stats={})


def _reference(params, tokens, segs, packed):
    """tpunet's micro math through jax.value_and_grad: the loss and the
    gradients as a port state dict."""
    from tpunet_torch.models.convert import lm_state_dict_from_jax

    model, x = jax_lm(), jnp.asarray(tokens)
    s = jnp.asarray(segs) if packed else None

    def loss_fn(p):
        kw = {"segment_ids": s} if packed else {}
        lg = model.apply({"params": p}, x, train=False, **kw)[:, :-1]
        ce = jax_ce_loss(lg, x[:, 1:], 0.0)
        if not packed:
            return ce.mean()
        wt = jax_weights(s)
        return jnp.sum(ce * wt) / jnp.maximum(jnp.sum(wt), 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), lm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))


def _jax_sums(params, tokens, segs, packed, accum=1):
    step = jax_lm_train_step(JaxOptimConfig(grad_accum=accum), _jax_cfg(),
                             packed=packed)
    _, m = jax.jit(step)(_jax_state(params), jnp.asarray(tokens),
                         jnp.asarray(segs), jax.random.PRNGKey(0))
    return {k: float(v) for k, v in m.items()}


def _port_step(params, tokens, segs, packed, accum=1):
    """One port ``fit_lm_batch`` (SGD at lr 0): gradients and sums."""
    model = port_lm(params)
    cfg = OptimConfig(name="sgd", learning_rate=0.0, grad_accum=accum)
    state = TrainState(model, make_optimizer(model.parameters(), cfg),
                       lambda t: 0.0)
    m = fit_lm_batch(state, torch.from_numpy(tokens), torch.from_numpy(segs),
                     torch.Generator(), cfg, packed=packed)
    return ({k: p.grad.clone() for k, p in model.named_parameters()},
            {k: v.item() for k, v in m.items()})


def _grads_within(got, want, tol):
    gmax = max(float(g.abs().max()) for g in want.values())
    assert gmax > 1e-3 and set(got) == set(want)
    for key, g in want.items():
        err = float((got[key] - g).abs().max())
        assert err <= tol * gmax, (key, err, gmax)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_train_step_matches_tpunet(setup, packed):
    params, tokens, segs = setup
    jloss, jgrads = _reference(params, tokens, segs, packed)
    want = _jax_sums(params, tokens, segs, packed)
    grads, got = _port_step(params, tokens, segs, packed)
    assert got["loss_sum"] / got["count"] == pytest.approx(jloss, rel=1e-5)
    assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
    assert got["correct"] == want["correct"] > 0
    assert got["count"] == want["count"]
    if packed:
        assert got["count"] == float(jax_weights(jnp.asarray(segs)).sum())
        assert got["count"] < B * (T - 1)
    else:
        assert got["count"] == B * (T - 1)
    _grads_within(grads, jgrads, 1e-5)


def test_packed_grad_accum_two_equals_accum_one(setup):
    params, tokens, segs = setup
    one, _ = _port_step(params, tokens, segs, True)
    two, got = _port_step(params, tokens, segs, True, accum=2)
    _grads_within(two, one, 1e-6)
    want = _jax_sums(params, tokens, segs, True, accum=2)
    assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
    assert (got["correct"], got["count"]) == (want["correct"], want["count"])


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_eval_step_matches_tpunet(setup, packed):
    params, tokens, segs = setup
    mask = np.array([1.0] * (B - 3) + [0.0] * 3, np.float32)
    want = jax_lm_eval_step(_jax_cfg(), packed=packed)(
        _jax_state(params), jnp.asarray(tokens), jnp.asarray(segs),
        jnp.asarray(mask))
    got = make_lm_eval_step(packed)(port_lm(params), torch.from_numpy(tokens),
                                    torch.from_numpy(segs),
                                    torch.from_numpy(mask))
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-5)
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["count"]) == float(want["count"])


def test_two_ranks_packed_equal_world_one(setup, tmp_path):
    params, tokens, segs = setup
    model = port_lm(params)
    torch.save(model.state_dict(), tmp_path / "lm.pt")
    np.savez(tmp_path / "lm_inputs.npz", tokens=tokens, segs=segs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp_path),
                               "2", str(r), "lm"], env=env, cwd=ROOT,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    r0, r1 = (torch.load(tmp_path / f"lm_w2_rank{r}.pt", weights_only=False)
              for r in range(2))
    # The ranks' shares of the valid targets differ: each must divide
    # by the global count for 2 ranks to take the global batch's step.
    assert r0[1]["metrics"]["count"] != r1[1]["metrics"]["count"]
    want, wm = _port_step(params, tokens, segs, True)
    for accum in (1, 2):
        a, b = r0[accum], r1[accum]
        loss = ((a["metrics"]["loss_sum"] + b["metrics"]["loss_sum"])
                / (a["metrics"]["count"] + b["metrics"]["count"]))
        assert loss == pytest.approx(wm["loss_sum"] / wm["count"], rel=1e-6)
        _grads_within(a["grads"], want, 1e-5)
        for key in want:
            assert torch.equal(a["grads"][key], b["grads"][key]), key


# -- the trainer ---------------------------------------------------------


def _corpus(tmp_path):
    rng = np.random.default_rng(8)
    words = ["the", "flash", "kernel", "packs", "rows", "of", "text", "a"]
    lines = [" ".join(rng.choice(words, int(rng.integers(1, 9))))
             for _ in range(160)]
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _data_flags(kind, tmp_path):
    if kind == "synthetic_lm":
        return ["--dataset", "synthetic_lm", "--vocab-size", "64",
                "--synthetic-size", "64"]
    return ["--dataset", "text_lm", "--text-file", _corpus(tmp_path),
            "--pack-docs"]


@pytest.mark.parametrize("kind", ["synthetic_lm", "packed_text_lm"])
def test_cli_epoch_best_pth_and_eval_only(tmp_path, capsys, kind):
    ck = tmp_path / "ck"
    flags = CLI_LM + _data_flags(kind, tmp_path) + ["--checkpoint-dir",
                                                    str(ck)]
    assert cli.main(flags + ["--epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^Epoch 1/1 Time: .* Test Acc: [\d.]+$", out, re.M)
    record = [json.loads(line) for line in (ck / "metrics.jsonl")
              .read_text().splitlines() if '"kind"' not in line][-1]
    assert record["tokens_per_sec"] > 0 and "examples_per_sec" not in record
    assert (ck / "state.pt").exists()
    cfg, _ = cli.config_from_args(flags + ["--eval-only"])
    assert cfg.model.max_seq_len == 1024 and cfg.data.seq_len == 32
    trainer = Trainer(cfg, device="cpu")
    load_state_dict_file(str(ck / "best.pth"), trainer.state.model)
    assert trainer.evaluate()["accuracy"] == record["test_accuracy"]
    assert cli.main(flags + ["--eval-only"]) == 0
    found = re.search(r"Eval: Test Loss: [\d.]+ Test Acc: ([\d.]+)",
                      capsys.readouterr().out)
    assert found and float(found.group(1)) == pytest.approx(
        record["test_accuracy"], abs=5e-5)


def test_resume_of_a_packed_lm_run_is_bit_exact(tmp_path):
    corpus = _corpus(tmp_path)

    def cfg(directory, epochs, resume=False):
        return TrainConfig(
            epochs=epochs, seed=3,
            data=DataConfig(dataset="text_lm", text_path=corpus, seq_len=32,
                            pack_docs=True, batch_size=8),
            model=ModelConfig(name="lm", vit_hidden=32, vit_depth=2,
                              vit_heads=2, dtype="float32", dropout_rate=0.1),
            checkpoint=CheckpointConfig(directory=str(directory),
                                        resume=resume))

    full = Trainer(cfg(tmp_path / "a", 2), device="cpu")
    history = full.train()
    Trainer(cfg(tmp_path / "b", 1), device="cpu").train()
    resumed = Trainer(cfg(tmp_path / "b", 2, resume=True), device="cpu")
    assert resumed.start_epoch == 2
    assert resumed.train()[0]["test_loss"] == history[1]["test_loss"]
    a, b = full.state.model.state_dict(), resumed.state.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kw,match", [
    (dict(model=ModelConfig(name="lm")), "different families"),
    (dict(data=DataConfig(dataset="synthetic_lm")), "different families"),
    (dict(model=ModelConfig(name="lm", vocab_size=64),
          data=DataConfig(dataset="synthetic_lm")), "vocab"),
    (dict(model=ModelConfig(name="lm", attention="blockwise"),
          data=DataConfig(dataset="text_lm", pack_docs=True)),
     "segment-capable")],
    ids=["lm_on_images", "vit_on_tokens", "vocab", "packed_blockwise"])
def test_trainer_cross_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig(**kw)
