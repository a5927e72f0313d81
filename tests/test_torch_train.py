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
- ``--pretrained`` with a 1000-class ``.pth`` from tpunet's
  ``export_torch_state_dict``: the first step's train-mode logits equal
  tpunet's ``load_pretrained`` path; ``--param-dtype bfloat16`` keeps
  parameters and Adam's moments in bf16, against tpunet at bf16
  tolerance.
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
from tpunet.models.convert import export_torch_state_dict, load_pretrained
from tpunet.train.state import lr_schedule as jax_lr_schedule
from tpunet_torch.config import (CheckpointConfig, DataConfig, MeshConfig,
                                 ModelConfig, ObsConfig, OptimConfig,
                                 TrainConfig, preset)
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict, state_dict_from_jax
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer
from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
from tpunet_torch.utils.prng import step_generator

from _torch_port import SIZE, WIDTH, nchw, train_variables
import _torch_threads  # noqa: E402,F401

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


# -- --pretrained and --param-dtype ---------------------------------------

# The small CLI run of these tests (the Trainer is built, not run).
SMALL_CLI = ["--preset", "single", "--dataset", "synthetic",
             "--synthetic-size", "48", "--image-size", str(SIZE),
             "--batch-size", "16", "--width-mult", str(WIDTH), "--dtype",
             "float32", "--pallas-depthwise", "--no-download"]


def test_pretrained_imagenet_pth_gives_tpunets_first_step_logits(tmp_path):
    """A 1000-class .pth written by tpunet's export_torch_state_dict,
    through the port's ``--pretrained`` and through tpunet's
    load_pretrained: the backbone is the file's, the head each package's
    fresh init (tpunet's is copied into the port to compare), and the
    first step's train-mode logits agree at the train-mode tolerances
    (rtol 1e-3, atol 1e-3, as train_pass)."""
    params, stats = train_variables(seed=2)
    rng = np.random.default_rng(11)
    c = params["classifier"]["kernel"].shape[0]
    imagenet = dict(params, classifier={
        "kernel": rng.normal(0, 0.01, (c, 1000)).astype(np.float32),
        "bias": rng.normal(0, 0.01, 1000).astype(np.float32)})
    pth = tmp_path / "imagenet.pth"
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in export_torch_state_dict(imagenet, stats).items()},
               pth)

    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH,
                                             dropout_rate=0.0))
    init = jax.jit(lambda key: init_variables(jmodel, key, image_size=SIZE))
    variables = load_pretrained(str(pth), init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(9).standard_normal(
        (N_TRAIN, SIZE, SIZE, 3)).astype(np.float32)
    want, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])

    cfg, device = cli.config_from_args(SMALL_CLI + ["--pretrained", str(pth)])
    assert cfg.model.pretrained_path == str(pth)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout_rate=0.0))
    trainer = Trainer(cfg, device="cpu")
    model = trainer.state.model
    got_sd = model.state_dict()
    file_sd = torch.load(pth, weights_only=True)
    head = type(model).HEAD_KEYS
    for k, v in got_sd.items():
        if k not in head:
            assert torch.equal(v, file_sd[k]), k
    fresh = create_model(cfg.model, device="cpu", image_size=SIZE,
                         generator=torch.Generator().manual_seed(cfg.seed))
    for k in head:
        assert torch.equal(got_sd[k], fresh.state_dict()[k]), k
    jhead = variables["params"]["classifier"]
    with torch.no_grad():
        model.classifier[1].weight.copy_(torch.from_numpy(
            np.array(jhead["kernel"]).T.copy()))
        model.classifier[1].bias.copy_(torch.from_numpy(
            np.array(jhead["bias"])))
    got = model(nchw(x), train=True, generator=step_generator(cfg.seed, 0))
    assert np.abs(np.asarray(want)).max() > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-3, atol=1e-3)


def test_param_dtype_bfloat16_matches_tpunet():
    """``--param-dtype bfloat16`` (float32 compute): one train-mode step
    of both packages from the same bf16 parameters. Parameters and
    Adam's moments are bf16 in both, the BN statistics float32. Adam's
    first moment (0.1 g) agrees within one bf16 rounding of the largest
    (2^-8 of it; the float32 drift through the train-mode BNs, 1e-3 of
    the largest at seed 2's float32 weights in train_pass, reaches 1.3e-3
    at their bf16 rounding) plus one of its own (2^-8 relative); so
    does the square root of the second. Each updated parameter equals
    tpunet's to one bf16 spacing of the parameter (2^-7 |p|) plus the
    bf16 roundings of Adam's step, which both packages round in their
    own order (about eight of 2^-9 each: 2^-6 of the learning rate),
    where the gradient's sign is certain (|m| above 2^-7 of the
    largest), else to twice the learning rate plus that."""
    lr = 1e-2
    params, stats = train_variables(seed=2)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    x = np.random.default_rng(9).standard_normal(
        (N_TRAIN, SIZE, SIZE, 3)).astype(np.float32)
    y = np.arange(N_TRAIN, dtype=np.int64)
    jmodel = jax_create_model(JaxModelConfig(
        dtype="float32", param_dtype="bfloat16", width_mult=WIDTH,
        dropout_rate=0.0))

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32)).mean()

    jgrads = jax.jit(jax.grad(loss_fn))(bf)
    tx = optax.adam(lr)
    upd, jopt = tx.update(jgrads, tx.init(bf), bf)
    jnew = optax.apply_updates(bf, upd)
    mu, nu = jopt[0].mu, jopt[0].nu
    assert all(a.dtype == jnp.bfloat16 for a in
               jax.tree_util.tree_leaves((jnew, mu, nu)))

    cfg, _ = cli.config_from_args(SMALL_CLI + [
        "--param-dtype", "bfloat16", "--lr", str(lr)])
    assert cfg.model.param_dtype == "bfloat16"
    cfg_model = dataclasses.replace(cfg.model, dropout_rate=0.0, fused_ir=True)
    model = create_model(cfg_model, device="cpu", image_size=SIZE)
    assert load_state_dict(model, state_dict_from_jax(params, stats))
    state = TrainState(model, make_optimizer(model.parameters(), cfg.optim),
                       lr_schedule(cfg.optim, 1, 1))
    F.cross_entropy(model(nchw(x), train=True, generator=torch.Generator()),
                    torch.from_numpy(y)).backward()
    state.apply_gradients()
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in model.buffers() if b.is_floating_point()} == {
        torch.float32}
    opt = state.optimizer.state
    assert {opt[p][k].dtype for p in model.parameters()
            for k in ("exp_avg", "exp_avg_sq")} == {torch.bfloat16}

    names = dict(model.named_parameters())
    f32 = lambda t: np.asarray(t, np.float32)
    want_m = {k: f32(v) for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(f32, mu), stats).items() if k in names}
    want_v = {k: f32(v) for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(f32, nu), stats).items() if k in names}
    want_p = {k: f32(v) for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(f32, jnew), stats).items() if k in names}
    m_max = max(np.abs(v).max() for v in want_m.values())
    r_max = max(np.sqrt(v).max() for v in want_v.values())
    for k, p in names.items():
        m = opt[p]["exp_avg"].float().numpy()
        r = opt[p]["exp_avg_sq"].float().sqrt().numpy()
        np.testing.assert_array_less(
            np.abs(m - want_m[k]), 2.0**-8 * (m_max + np.abs(want_m[k]))
            + 1e-30, err_msg=k)
        np.testing.assert_array_less(
            np.abs(r - np.sqrt(want_v[k])),
            2.0**-8 * (r_max + np.sqrt(want_v[k])) + 1e-30, err_msg=k)
        new = p.detach().float().numpy()
        sure = np.abs(want_m[k]) > 2.0**-7 * m_max
        spacing = 2.0**-7 * np.abs(want_p[k]) + 2.0**-6 * lr
        np.testing.assert_array_less(np.abs(new - want_p[k]),
                                     np.where(sure, spacing,
                                              2 * lr + spacing) + 1e-30,
                                     err_msg=k)


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
    lambda: ModelConfig(pretrained_path="auto"),
    lambda: ModelConfig(name="lm_pp", pretrained_path="auto"),
    lambda: ModelConfig(name="vit_pp", pretrained_path="auto")],
    ids=["auto_weights", "mesh_pipe", "vit_pp"])
def test_unported_fields_raise_with_their_roadmap_item(make):
    """What the port still refuses: the download of ``pretrained='auto'``
    (for every model, the pipelined ones too). Pipeline parallelism and
    MoE on the pipelined models are ported (tests/test_torch_{pp,vitpp,
    lmpp}.py), and so is MoE itself (tests/test_torch_moe.py). Item
    2b's fields are ported (tests/test_torch_{mixup,ema,native,
    preemption,remat}.py), and so are the mesh's 'data'/'model' axes,
    ZeRO-1, FSDP, the vocab-parallel CE (tests/test_torch_{tp,fsdp,
    vocab_ce}.py), sequence parallelism
    (:func:`test_sequence_parallel_fields_are_accepted`) and the elastic
    fields (:func:`test_elastic_fields_are_accepted`)."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        make()


@pytest.mark.parametrize("argv", [
    ["--evict-on-straggler"],
    ["--chaos", "kill@ckpt=2:gen=0;slow@step=8:delay=3:steps=4"],
    ["--evict-on-straggler", "--chaos", "slow@step=10:delay=1.5:host=1",
     "--stall-factor", "3", "--stall-min-s", "0.2"]],
    ids=["moe", "chaos", "evict_chaos"])
def test_elastic_fields_are_accepted(argv):
    """The elastic fields (Queue A items 12 and 9b) build and map as
    tpunet's: ``ObsConfig.evict_on_straggler`` (refused before the agent
    was ported; this test's first case) and ``TrainConfig.chaos``."""
    from tpunet.config import config_from_args as jax_config_from_args
    assert ObsConfig(evict_on_straggler=True).evict_on_straggler
    got, _ = cli.config_from_args(argv)
    want = jax_config_from_args(argv)
    assert got.chaos == want.chaos
    assert got.obs.evict_on_straggler == want.obs.evict_on_straggler
    assert (got.obs.stall_factor, got.obs.stall_min_s) == \
        (want.obs.stall_factor, want.obs.stall_min_s)


@pytest.mark.parametrize("make,argv", [
    (lambda: ModelConfig(name="vit", attention="ring"),
     ["--model", "vit", "--attention", "ring", "--mesh-seq", "2"]),
    (lambda: MeshConfig(seq=2),
     ["--model", "lm", "--dataset", "synthetic_lm", "--attention",
      "ulysses", "--mesh-seq", "2"]),
    (lambda: ModelConfig(name="vit", attention_core="flash"),
     ["--model", "vit", "--attention", "ring", "--attention-core",
      "flash"])],
    ids=["ring", "mesh_seq", "attention_core"])
def test_sequence_parallel_fields_are_accepted(make, argv):
    """The values refused until sequence parallelism was ported (ROADMAP
    Queue A item 8b; tests/test_torch_seq*.py run them): each now
    constructs, and the CLI flags that set it give tpunet's mesh and
    attention fields."""
    from tpunet.config import config_from_args as jax_config_from_args
    make()
    got, _ = cli.config_from_args(argv)
    want = jax_config_from_args(argv)
    for f in dataclasses.fields(got.mesh):
        assert getattr(got.mesh, f.name) == getattr(want.mesh, f.name), f.name
    for f in ("name", "attention", "attention_core", "attention_block"):
        assert getattr(got.model, f) == getattr(want.model, f), f


def test_cli_maps_flags_and_refuses_the_rest():
    cfg, device = cli.config_from_args(
        ["--preset", "serial", "--epochs", "3", "--lr", "0.01",
         "--lr-schedule", "cosine", "--warmup-epochs", "0.5",
         "--label-smoothing", "0.1", "--seed", "9", "--no-fused-ir",
         "--pallas-depthwise", "--width-mult", "0.5", "--dtype", "float32",
         "--device", "cpu", "--log-every-steps", "4",
         "--checkpoint-dir", "x", "--resume", "--optimizer", "adamw",
         "--weight-decay", "0.05", "--dropout-rate", "0.1",
         "--grad-accum", "4", "--clip-norm", "2.5", "--mixup", "0.2",
         "--cutmix", "1.0", "--ema-decay", "0.9", "--no-download",
         "--no-native-loader", "--pretrained", "w.pth", "--block-remat",
         "--param-dtype", "bfloat16", "--preempt-grace-s", "30"])
    assert device == "cpu" and cfg.epochs == 3 and cfg.seed == 9
    assert cfg.data.batch_size == 64 and cfg.log_every_steps == 4
    assert cfg.optim.learning_rate == 0.01 and cfg.optim.schedule == "cosine"
    assert cfg.optim.label_smoothing == 0.1
    assert cfg.optim.name == "adamw" and cfg.optim.weight_decay == 0.05
    assert cfg.optim.grad_accum == 4 and cfg.optim.clip_norm == 2.5
    assert cfg.model.dropout_rate == 0.1
    assert not cfg.model.fused_ir and cfg.model.use_pallas_depthwise
    assert cfg.checkpoint.directory == "x" and cfg.checkpoint.resume
    assert cfg.data.mixup_alpha == 0.2 and cfg.data.cutmix_alpha == 1.0
    assert cfg.optim.ema_decay == 0.9
    assert not cfg.data.download and not cfg.data.native_loader
    assert cfg.model.pretrained_path == "w.pth" and cfg.model.block_remat
    assert cfg.model.param_dtype == "bfloat16"
    assert cfg.preempt_grace_s == 30.0
    lm, _ = cli.config_from_args(["--model", "lm", "--dataset",
                                  "synthetic_lm", "--remat"])
    assert lm.model.remat
    mesh, _ = cli.config_from_args(["--model", "lm", "--dataset",
                                    "synthetic_lm", "--mesh-data", "2",
                                    "--mesh-model", "2", "--zero1", "--fsdp",
                                    "--vocab-ce", "sharded"])
    assert mesh.mesh == MeshConfig(data=2, model=2, zero1=True, fsdp=True)
    assert mesh.model.vocab_ce == "sharded"
    with pytest.raises(SystemExit):
        cli.config_from_args(["--optimizer", "lamb"])
    # Pipeline parallelism (ROADMAP Queue A item 8d): the flags map.
    pp, _ = cli.config_from_args(["--model", "lm_pp", "--dataset",
                                  "synthetic_lm", "--mesh-pipe", "2",
                                  "--pp-microbatches", "8", "--pp-schedule",
                                  "interleaved", "--pp-virtual", "3"])
    assert pp.mesh == MeshConfig(pipe=2)
    assert (pp.model.pp_microbatches, pp.model.pp_schedule,
            pp.model.pp_virtual) == (8, "interleaved", 3)
    # Sequence parallelism (ROADMAP Queue A item 8b): the flags map, and
    # --mesh-seq shards the tokens of a ViT or the LM under ring/ulysses.
    seq, _ = cli.config_from_args(["--model", "lm", "--dataset",
                                   "synthetic_lm", "--attention", "ring",
                                   "--attention-core", "flash",
                                   "--mesh-seq", "2"])
    assert seq.mesh == MeshConfig(seq=2)
    assert (seq.model.attention, seq.model.attention_core) == ("ring",
                                                               "flash")
    with pytest.raises(ValueError, match="needs --attention ring or ulysses"):
        cli.config_from_args(["--mesh-seq", "2"])
    # The one item-2b value still refused: a download of the weights.
    with pytest.raises(NotImplementedError, match="download"):
        cli.config_from_args(["--pretrained", "auto"])
    assert os.path.basename(cli.__file__) == "__main__.py"
