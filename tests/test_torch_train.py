"""Parity of the port's training slice with tpunet's, on the CPU.

- One float32 train-mode forward/backward of MobileNetV2 from shared
  weights (tests/_torch_port.py's ``train_variables``, dropout 0, 8
  images) against tpunet's
  ``model.apply(..., train=True, mutable=["batch_stats"])`` and
  ``jax.value_and_grad``: logits, loss, the gradient of every parameter
  and the updated running statistics (the biased batch var).
- The optimizer stack: parameters after 3 updates against optax, the
  learning rate of every step against tpunet's schedule.
- The Trainer: a 2-epoch synthetic 32 px run prints the reference's
  epoch line; 1 epoch + ``--resume`` + 1 epoch equals 2 epochs to the
  bit; the best ``.pth`` loads into ``tpunet.models.convert.load_pretrained``
  and gives the same eval logits.
- Train mode never reads the eval-mode constant cache, and eval after a
  step sees the updated weights.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import OptimConfig as JaxOptimConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.models.convert import load_pretrained
from tpunet.train.state import lr_schedule as jax_lr_schedule
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 OptimConfig, TrainConfig, preset)
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict, state_dict_from_jax
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer
from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
from tpunet_torch.utils.prng import step_generator

from _torch_port import SIZE, WIDTH, nchw, train_variables

# Train-mode BN over few images is ill-conditioned: 8 images, not 2 or
# 4, so that the 1x1 tail of a 32 px net reduces over 8 samples.
N_TRAIN = 8


@pytest.fixture(scope="module")
def train_pass():
    """One float32 train-mode forward/backward through both packages.

    Tolerances are those of tpunet's own train-mode parity tests
    (tests/test_fused_bn.py): float32 reassociation through the stacked
    train-mode BNs drifts logits by ~1e-3, running statistics within
    rtol 1e-3 / atol 1e-4, gradients within 1e-3 of the largest gradient
    of the net. The drift depends on the weights: at random init a
    channel whose mean dwarfs its spread makes the single-pass variance
    E[x^2] - E[x]^2 (tpunet's formula, kept by the port) cancel, and the
    backward amplifies the rounding. Over tpunet's init seeds 0-4 the
    gradient error is 2e-4, 5.7e-2, 2e-4, 3.1e-3 and 1.9e-2 of the largest
    gradient; seed 2 has no such channel, and any error in the port's
    math shows far above 1e-3 there."""
    params, stats = train_variables(seed=2)
    x = np.random.default_rng(9).standard_normal(
        (N_TRAIN, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int64)
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH,
                                             dropout_rate=0.0))

    def loss_fn(p):
        logits, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32)).mean()
        return loss, (logits, mut["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                     dropout_rate=0.0,
                                     use_pallas_depthwise=True,
                                     fused_ir=True), device="cpu")
    assert load_state_dict(model, state_dict_from_jax(params, stats))
    logits = model(nchw(x), train=True, generator=torch.Generator())
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return dict(model=model, logits=logits.detach().numpy(),
                loss=loss.item(), jlogits=np.asarray(jlogits),
                jloss=float(jloss),
                want_grads=state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, jgrads), stats),
                want_stats=state_dict_from_jax(
                    params, jax.tree_util.tree_map(np.asarray, jstats)))


def test_train_logits_and_loss_match_tpunet(train_pass):
    np.testing.assert_allclose(train_pass["logits"], train_pass["jlogits"],
                               rtol=1e-3, atol=1e-3)
    assert abs(train_pass["loss"] - train_pass["jloss"]) < 1e-4


def test_every_gradient_matches_tpunet(train_pass):
    """All 158 parameters' gradients within 1e-3 of the net's largest."""
    model, want = train_pass["model"], train_pass["want_grads"]
    names = dict(model.named_parameters())
    assert len(names) == 158
    gmax = max(float(want[k].abs().max()) for k in names)
    for key, p in names.items():
        err = float((p.grad - want[key]).abs().max())
        assert err <= 1e-3 * gmax, (key, err, gmax)


def test_running_stats_update_matches_tpunet(train_pass):
    """0.9 * running + 0.1 * batch, with the biased batch var."""
    model, want = train_pass["model"], train_pass["want_stats"]
    n = 0
    for key, v in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[key].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=key)
            n += 1
        elif key.endswith("num_batches_tracked"):
            assert int(v) == 1
    assert n == 2 * 52


# -- optimizer stack -------------------------------------------------------


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adamw", 0.05),
                                     ("sgd", 0.0)])
def test_three_updates_match_optax(name, wd):
    """StepLR with a boundary inside the 3 updates (1 step an epoch,
    decay every 2 epochs): parameters after 3 updates to 1e-6."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(name=name, learning_rate=1e-2, weight_decay=wd,
              step_size_epochs=2, gamma=0.1)
    schedule = jax_lr_schedule(JaxOptimConfig(**kw), 1, 4)
    if name == "adam":
        tx = optax.adam(schedule)
    elif name == "adamw":
        tx = optax.adamw(schedule, weight_decay=wd)
    else:
        tx = optax.sgd(schedule, momentum=0.9)
    jp = [jnp.asarray(a) for a in p0]
    opt = tx.init(jp)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(a) for a in g], opt, jp)
        jp = optax.apply_updates(jp, upd)

    cfg = OptimConfig(**kw)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    state = TrainState(torch.nn.ParameterList(tp), make_optimizer(tp, cfg),
                       lr_schedule(cfg, 1, 4))
    for g in grads:
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        state.apply_gradients()
    assert state.global_step == 3
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,spe,epochs", [
    ({}, 3, 25),                                     # StepLR(10, 0.1)
    ({"warmup_epochs": 1.5}, 4, 22),                 # warmup, then StepLR
    ({"schedule": "cosine", "warmup_epochs": 2}, 5, 9),
    ({"schedule": "cosine"}, 7, 3),
    ({"schedule": "constant", "warmup_epochs": 0.5}, 6, 4),
], ids=["step", "warmup_step", "warmup_cosine", "cosine", "constant"])
def test_lr_schedule_matches_tpunet_at_every_step(kw, spe, epochs):
    """optax evaluates the schedule in float32, the port in float64: 1e-5."""
    want = jax_lr_schedule(JaxOptimConfig(**kw), spe, epochs)
    got = lr_schedule(OptimConfig(**kw), spe, epochs)
    for t in range(spe * epochs + 3):
        assert got(t) == pytest.approx(float(want(t)), rel=1e-5, abs=1e-12), t


def test_steplr_boundary_is_torchs_epoch_tick():
    """Update index 10 * steps_per_epoch is the first at the decayed rate."""
    s = lr_schedule(OptimConfig(), 7, 20)
    assert s(69) == pytest.approx(1e-4) and s(70) == pytest.approx(1e-5)
    assert s(139) == pytest.approx(1e-5) and s(140) == pytest.approx(1e-6)


# -- trainer ---------------------------------------------------------------


def _cfg(directory, epochs=2, resume=False):
    return TrainConfig(
        epochs=epochs, seed=5,
        data=DataConfig(dataset="synthetic", image_size=SIZE, batch_size=16,
                        synthetic_train_size=48, synthetic_test_size=20),
        model=ModelConfig(dtype="float32", width_mult=WIDTH,
                          use_pallas_depthwise=True),
        checkpoint=CheckpointConfig(directory=str(directory), resume=resume))


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    d = tmp_path_factory.mktemp("two")
    trainer = Trainer(_cfg(d), device="cpu")
    history = trainer.train()
    return d, trainer, history


EPOCH_LINE = re.compile(r"^Epoch (\d+)/2 Time: [\d.]+s Train Loss: [\d.]+ "
                        r"Train Acc: [\d.]+ Test Loss: [\d.]+ Test Acc: [\d.]+$",
                        re.M)


def test_trainer_two_epochs_prints_the_epoch_line(tmp_path, capsys):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    history = trainer.train()
    out = capsys.readouterr().out
    assert [int(e) for e in EPOCH_LINE.findall(out)] == [1, 2]
    assert "Best test accuracy: " in out and "Total training time: " in out
    assert [r["epoch"] for r in history] == [1, 2]
    assert trainer.global_step == 2 * 3
    # The plain epoch records; the obs records (obs_epoch, one an epoch)
    # share the file.
    records = [line for line in open(tmp_path / "metrics.jsonl")
               if '"kind"' not in line]
    assert len(records) == 2
    for key in ("run_id", "epoch", "seconds", "step", "examples_per_sec",
                "train_loss", "train_accuracy", "test_loss",
                "test_accuracy"):
        assert all(f'"{key}"' in r for r in records)
    assert (tmp_path / "best.pth").exists() and (tmp_path / "state.pt").exists()


def test_resume_is_bit_exact(two_epochs, tmp_path):
    """1 epoch, then --resume for the second: the same weights, optimizer
    state and epoch-2 metrics as 2 epochs in one run."""
    _, full, history = two_epochs
    Trainer(_cfg(tmp_path, epochs=1), device="cpu").train()
    resumed = Trainer(_cfg(tmp_path, epochs=2, resume=True), device="cpu")
    assert resumed.start_epoch == 2 and resumed.global_step == 3
    h2 = resumed.train()
    assert len(h2) == 1 and h2[0]["epoch"] == 2
    for key in ("train_loss", "train_accuracy", "test_loss",
                "test_accuracy", "step"):
        assert h2[0][key] == history[1][key], key
    a, b = full.state.model.state_dict(), resumed.state.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa = full.state.optimizer.state_dict()["state"]
    sb = resumed.state.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_best_pth_loads_into_tpunet(two_epochs):
    """The best .pth is a torchvision-layout state dict: tpunet's
    load_pretrained takes it, and both packages' eval logits agree."""
    d, _, _ = two_epochs
    port = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                        device="cpu")
    from tpunet_torch.models.convert import load_state_dict_file
    assert load_state_dict_file(str(d / "best.pth"), port)
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH))
    init = jax.jit(lambda key: init_variables(jmodel, key, image_size=SIZE))
    variables = load_pretrained(str(d / "best.pth"),
                                init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(4).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_eval_only_evaluates_the_best_checkpoint(two_epochs, capsys):
    d, trainer, history = two_epochs
    best = max(r["test_accuracy"] for r in history)
    again = Trainer(dataclasses.replace(_cfg(d), eval_only=True),
                    device="cpu")
    assert again.evaluate_checkpoint()["accuracy"] == best
    assert cli.main(["--preset", "single", "--dataset", "synthetic",
                     "--synthetic-size", "48", "--image-size", str(SIZE),
                     "--batch-size", "16", "--eval-batch-size", "20",
                     "--width-mult", str(WIDTH), "--dtype", "float32",
                     "--pallas-depthwise", "--checkpoint-dir", str(d),
                     "--eval-only", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"Eval: Test Loss: [\d.]+ Test Acc: [\d.]+", out)


# -- train mode and the eval cache -----------------------------------------


def test_train_mode_skips_the_eval_cache_and_eval_sees_updates():
    torch.manual_seed(0)
    cfg = ModelConfig(dtype="float32", width_mult=WIDTH,
                      use_pallas_depthwise=True)
    model = create_model(cfg, device="cpu")
    x = torch.randn(N_TRAIN, 3, SIZE, SIZE)
    with torch.no_grad():
        before = model(x)                      # fills the eval cache
    assert model._consts
    opt = make_optimizer(model.parameters(), OptimConfig(learning_rate=1e-2))
    out = model(x, train=True, generator=step_generator(0, 0))
    F.cross_entropy(out, torch.arange(N_TRAIN) % 10).backward()
    for key, p in model.named_parameters():
        assert p.grad is not None and bool((p.grad != 0).any()), key
    opt.step()
    with torch.no_grad():
        after = model(x)
    fresh = create_model(cfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = fresh(x)
    torch.testing.assert_close(after, want, rtol=0, atol=0)
    assert not torch.allclose(after, before)


def test_step_generator_is_a_function_of_seed_and_step():
    a = torch.rand(5, generator=step_generator(42, 7))
    assert torch.equal(a, torch.rand(5, generator=step_generator(42, 7)))
    assert not torch.equal(a, torch.rand(5, generator=step_generator(42, 8)))
    assert not torch.equal(a, torch.rand(5, generator=step_generator(43, 7)))


def test_dropout_keeps_one_minus_rate_and_rescales():
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                     dropout_rate=0.5), device="cpu")
    x = torch.randn(N_TRAIN, 3, SIZE, SIZE)
    a = model(x, train=True, generator=step_generator(1, 0))
    b = model(x, train=True, generator=step_generator(1, 0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        model(x, train=True)


# -- config and CLI ----------------------------------------------------------


def test_presets_and_defaults_match_tpunet():
    from tpunet.config import preset as jax_preset
    for name in ("serial", "single", "distributed"):
        got, want = preset(name), jax_preset(name)
        assert got.epochs == want.epochs == 20 and got.seed == want.seed == 42
        assert got.data.batch_size == want.data.batch_size
        jo = dataclasses.asdict(want.optim)
        assert dataclasses.asdict(got.optim) == {k: jo[k] for k in
                                                 dataclasses.asdict(got.optim)}
        jm = dataclasses.asdict(want.model)
        pm = dataclasses.asdict(got.model)
        assert pm == {k: jm[k] for k in pm}
        jd = dataclasses.asdict(want.data)
        pd = dataclasses.asdict(got.data)
        assert pd == {k: jd[k] for k in pd}
    # 128 a rank, the single config (tpunet/config.py:717-718).
    assert preset("distributed") == preset("single")


@pytest.mark.parametrize("make", [
    lambda: OptimConfig(ema_decay=0.999), lambda: DataConfig(mixup_alpha=0.2),
    lambda: DataConfig(cutmix_alpha=1.0),
    lambda: DataConfig(native_loader=False),
    lambda: ModelConfig(block_remat=True),
    lambda: ModelConfig(pretrained_path="auto")],
    ids=["ema", "mixup", "cutmix", "native_loader", "remat",
         "auto_weights"])
def test_unported_fields_raise_with_their_roadmap_item(make):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        make()


def test_cli_maps_flags_and_refuses_the_rest():
    cfg, device = cli.config_from_args(
        ["--preset", "serial", "--epochs", "3", "--lr", "0.01",
         "--lr-schedule", "cosine", "--warmup-epochs", "0.5",
         "--label-smoothing", "0.1", "--seed", "9", "--no-fused-ir",
         "--pallas-depthwise", "--width-mult", "0.5", "--dtype", "float32",
         "--device", "cpu", "--log-every-steps", "4",
         "--checkpoint-dir", "x", "--resume", "--optimizer", "adamw",
         "--weight-decay", "0.05", "--dropout-rate", "0.1",
         "--grad-accum", "4", "--clip-norm", "2.5"])
    assert device == "cpu" and cfg.epochs == 3 and cfg.seed == 9
    assert cfg.data.batch_size == 64 and cfg.log_every_steps == 4
    assert cfg.optim.learning_rate == 0.01 and cfg.optim.schedule == "cosine"
    assert cfg.optim.label_smoothing == 0.1
    assert cfg.optim.name == "adamw" and cfg.optim.weight_decay == 0.05
    assert cfg.optim.grad_accum == 4 and cfg.optim.clip_norm == 2.5
    assert cfg.model.dropout_rate == 0.1
    assert not cfg.model.fused_ir and cfg.model.use_pallas_depthwise
    assert cfg.checkpoint.directory == "x" and cfg.checkpoint.resume
    for flag in (["--mixup", "0.2"], ["--mesh-data", "2"],
                 ["--ema-decay", "0.9"], ["--no-download"],
                 ["--pretrained", "w.pth"], ["--optimizer", "lamb"]):
        with pytest.raises(SystemExit):
            cli.config_from_args(flag)
    assert os.path.basename(cli.__file__) == "__main__.py"
