"""Mixup/CutMix of the port against tpunet's ``mixup_cutmix``, on the CPU.

- tpunet's draws (the permutation, the choice, Beta's lam0 and the box
  centre, replayed from its key splits, ``tpunet/data/augment.py:396``)
  fed to the port's ``mix_with_params`` give tpunet's images, partner
  labels and lam to the bit: mixup in float32 and CutMix;
- one train-mode MobileNetV2 forward/backward on mixed images with the
  mixed loss ``lam * CE(y) + (1 - lam) * CE(y_b)`` against tpunet's at
  the same lam, with the tolerances of the train-mode parity test
  (tests/test_torch_train.py: loss within 1e-4, every gradient within
  1e-3 of the largest);
- mirrors of tests/test_mixup.py's property tests on the port's draws;
- 2 (and 4) gloo ranks against 1 process: the permutation runs over the
  global batch, and each rank's mixed rows and partner labels are the
  rows of the one-process result, to the bit, after one collective
  (``fetch_rows``).
"""

import os
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
from tpunet.data.augment import mixup_cutmix
from tpunet.models import create_model as jax_create_model
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 OptimConfig, TrainConfig)
from tpunet_torch.data.augment import (make_mix, mix_with_params,
                                       sample_mix_params)
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict, state_dict_from_jax
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer
from tpunet_torch.train.state import TrainState, make_optimizer
from tpunet_torch.train.steps import fit_batch
from tpunet_torch.utils.prng import step_generator

from _torch_port import SIZE, WIDTH, train_variables
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


def _batch(b=8, h=16, w=16):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    return x, y


def tpunet_draws(key, b, mixup_alpha, cutmix_alpha):
    """The port's draw dict of tpunet's key: ``mixup_cutmix``'s splits."""
    kperm, kchoice, kmix, kcut, kbox = jax.random.split(key, 5)
    if mixup_alpha > 0 and cutmix_alpha > 0:
        mixup = bool(jax.random.bernoulli(kchoice))
    else:
        mixup = mixup_alpha > 0
    alpha = mixup_alpha if mixup else cutmix_alpha
    lam0 = jax.random.beta(kmix if mixup else kcut, alpha, alpha)
    return {"perm": torch.from_numpy(np.asarray(
                jax.random.permutation(kperm, b)).astype(np.int64)),
            "mixup": mixup,
            "lam0": float(np.asarray(lam0, np.float32)),
            "cy": float(jax.random.uniform(kbox, (), minval=0.0,
                                           maxval=1.0)),
            "cx": float(jax.random.uniform(jax.random.fold_in(kbox, 1), (),
                                           minval=0.0, maxval=1.0))}


@pytest.mark.parametrize("seed,alphas", [
    (1, (0.4, 0.0)), (5, (0.4, 0.0)), (2, (0.0, 1.0)), (7, (0.0, 1.0)),
    (3, (1.0, 1.0)), (4, (1.0, 1.0))],
    ids=["mixup1", "mixup5", "cutmix2", "cutmix7", "both3", "both4"])
def test_tpunets_draws_give_tpunets_images_to_the_bit(seed, alphas):
    """To the bit, except tpunet's mixup under ``lax.cond`` (both alphas
    set): XLA compiles that branch as one fused expression, which may
    round ``lam * x + (1 - lam) * x_b`` unlike the op-by-op product and
    sum (an FMA), so there it is held to two roundings of the two terms
    (2 float32 eps of their magnitudes), and the op-by-op formula of
    tpunet's branch to the bit."""
    x, y = _batch()
    key = jax.random.PRNGKey(seed)
    out, yb, lam = mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y), *alphas)
    draws = tpunet_draws(key, x.shape[0], *alphas)
    got, got_lam = mix_with_params(torch.from_numpy(x), draws)
    fused = draws["mixup"] and min(alphas) > 0
    if fused:
        lam32 = np.float32(draws["lam0"])
        xb = x[draws["perm"].numpy()]
        terms = np.abs(lam32 * x) + np.abs((np.float32(1) - lam32) * xb)
        eps = np.finfo(np.float32).eps
        assert (np.abs(got.numpy() - np.asarray(out))
                <= 2 * eps * terms).all()
        eager = lam32 * jnp.asarray(x) + (1.0 - lam32) * jnp.asarray(xb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    assert np.float32(got_lam) == np.asarray(lam, np.float32)
    np.testing.assert_array_equal(y[draws["perm"].numpy()], np.asarray(yb))


def test_mixed_step_matches_tpunets_loss_and_gradients():
    """One train-mode ``fit_batch`` (SGD at rate 0, so only the gradients
    move) whose mixer hands over tpunet's mixup of key 1: the inputs and
    lam are tpunet's, so the port's mixed loss and the model are what is
    compared."""
    params, stats = train_variables(seed=2)
    x = np.random.default_rng(9).standard_normal(
        (8, SIZE, SIZE, 3)).astype(np.float32)
    y = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int32)
    key = jax.random.PRNGKey(1)
    jx, jyb, jlam = mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y),
                                 0.4, 0.0)
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH,
                                             dropout_rate=0.0))

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, jx,
                                 train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels
        mixed = jlam * ce(logits, jnp.asarray(y)) + (1.0 - jlam) * ce(
            logits, jyb)
        return mixed.mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    draws = tpunet_draws(key, 8, 0.4, 0.0)

    def mix(generator, images, labels):
        out, lam = mix_with_params(images, draws)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jx))
        return out, labels[draws["perm"]], lam

    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                     dropout_rate=0.0,
                                     use_pallas_depthwise=True),
                         device="cpu")
    assert load_state_dict(model, state_dict_from_jax(params, stats))
    optim = OptimConfig(name="sgd", learning_rate=0.0)
    state = TrainState(model, make_optimizer(model.parameters(), optim),
                       lambda t: 0.0)
    m = fit_batch(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                  torch.Generator(), optim, mix)
    assert abs(float(m["loss_sum"]) / 8 - float(jloss)) < 1e-4
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                               stats)
    names = dict(model.named_parameters())
    gmax = max(float(want[k].abs().max()) for k in names)
    for k, p in names.items():
        assert float((p.grad - want[k]).abs().max()) <= 1e-3 * gmax, k


# -- mirrors of tests/test_mixup.py ------------------------------------------


def test_disabled_draws_nothing():
    """Both alphas 0: no mixing and no draw, so the step's generator
    stream is that of a run without the option."""
    assert make_mix(DataConfig(dataset="synthetic")) is None
    with pytest.raises(ValueError, match="both off"):
        sample_mix_params(torch.Generator(), 8, 0.0, 0.0)


def test_mixup_is_convex_combination():
    x, y = _batch()
    mix = make_mix(DataConfig(dataset="synthetic", mixup_alpha=0.4))
    out, yb, lam = mix(step_generator(0, 1), torch.from_numpy(x),
                       torch.from_numpy(y))
    assert 0.0 <= lam <= 1.0
    perm_x = (out.numpy() - lam * x) / max(1 - lam, 1e-9)
    for i in range(x.shape[0]):
        assert np.abs(x - perm_x[i]).mean(axis=(1, 2, 3)).min() < 1e-4
    assert sorted(yb.tolist()) == sorted(y.tolist())


def test_cutmix_pixels_come_from_two_sources():
    x, y = _batch()
    mix = make_mix(DataConfig(dataset="synthetic", cutmix_alpha=1.0))
    out, yb, lam = mix(step_generator(0, 2), torch.from_numpy(x),
                       torch.from_numpy(y))
    same = np.isclose(out.numpy(), x).all(-1)
    fixed = same.all(axis=(1, 2))
    assert not fixed.all()
    assert abs(same[~fixed].mean() - lam) < 0.05
    b0 = ~same[~fixed][0]
    if b0.any():
        rows, cols = np.where(b0.any(1))[0], np.where(b0.any(0))[0]
        assert b0[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1].all()


def test_both_alphas_pick_one_per_step():
    x, y = _batch()
    mix = make_mix(DataConfig(dataset="synthetic", mixup_alpha=1.0,
                              cutmix_alpha=1.0))
    kinds = set()
    for step in range(10):
        out, _, _ = mix(step_generator(0, step), torch.from_numpy(x),
                        torch.from_numpy(y))
        eq_any = np.isclose(out.numpy()[0][None], x).all(-1).any(0).mean()
        kinds.add("cutmix" if eq_any > 0.99 else "mixup")
    assert kinds == {"cutmix", "mixup"}, kinds


def test_trainer_with_mixup_and_cutmix(tmp_path):
    cfg = TrainConfig(
        epochs=1,
        data=DataConfig(dataset="synthetic", image_size=32, batch_size=16,
                        synthetic_train_size=32, synthetic_test_size=16,
                        mixup_alpha=0.4, cutmix_alpha=1.0),
        model=ModelConfig(name="vit", vit_patch=4, vit_hidden=32,
                          vit_depth=2, vit_heads=2, dropout_rate=0.0,
                          dtype="float32"),
        optim=OptimConfig(learning_rate=1e-3),
        checkpoint=CheckpointConfig(directory=str(tmp_path)))
    trainer = Trainer(cfg, device="cpu")
    try:
        m = trainer.train_one_epoch(1)
        assert np.isfinite(m["loss"]) and m["count"] == 32.0
        assert np.isfinite(trainer.evaluate()["loss"])
    finally:
        trainer.close()


def test_cli_flags():
    cfg, _ = cli.config_from_args(["--mixup", "0.4", "--cutmix", "1.0"])
    assert cfg.data.mixup_alpha == 0.4 and cfg.data.cutmix_alpha == 1.0


def test_validation(tmp_path):
    ck = CheckpointConfig(directory=str(tmp_path))
    lm = TrainConfig(
        data=DataConfig(dataset="synthetic_lm", batch_size=16,
                        synthetic_train_size=32, synthetic_test_size=16,
                        seq_len=32, vocab_size=32, mixup_alpha=0.4),
        model=ModelConfig(name="lm", vit_hidden=32, vit_depth=2,
                          vit_heads=2, dropout_rate=0.0, dtype="float32",
                          vocab_size=32, max_seq_len=32),
        checkpoint=ck)
    with pytest.raises(ValueError, match="image-family"):
        Trainer(lm, device="cpu")
    img = TrainConfig(
        data=DataConfig(dataset="synthetic", image_size=32, batch_size=16,
                        synthetic_train_size=32, synthetic_test_size=16,
                        mixup_alpha=-0.1),
        model=ModelConfig(name="vit", vit_patch=4, vit_hidden=32,
                          vit_depth=2, vit_heads=2, dtype="float32"),
        checkpoint=ck)
    with pytest.raises(ValueError, match=">= 0"):
        Trainer(img, device="cpu")


# -- 2 gloo ranks against 1 process --------------------------------------------


def run_workers(d: Path, world: int, case: str, timeout: float = 240.0):
    """``tests/_torch_item2b_worker.py`` as ``world`` rank subprocesses;
    each rank's saved results, in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    worker = ROOT / "tests" / "_torch_item2b_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(d), str(world), str(r), case],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(d / f"{case}_w{world}_rank{r}.pt",
                       weights_only=False) for r in range(world)]


def test_two_ranks_mix_the_global_batch_as_one_process(tmp_path):
    rng = np.random.default_rng(3)
    torch.save({"images": torch.from_numpy(rng.standard_normal(
                    (8, 16, 16, 3)).astype(np.float32)),
                "labels": torch.from_numpy(rng.integers(0, 10, 8))},
               tmp_path / "mix_inputs.pt")
    (one,) = run_workers(tmp_path, 1, "mix")
    for world in (2, 4):
        many = run_workers(tmp_path, world, "mix")
        for name in ("mixup", "cutmix"):
            assert one[name]["fetches"] == 0
            assert [r[name]["fetches"] for r in many] == [1] * world
            assert [r[name]["lam"] for r in many] == [one[name]["lam"]] * world
            got = torch.cat([r[name]["images"] for r in many])
            assert torch.equal(got, one[name]["images"]), (world, name)
            got_b = torch.cat([r[name]["labels_b"] for r in many])
            assert torch.equal(got_b, one[name]["labels_b"]), (world, name)
    # The permutation crosses the ranks: some row's partner lives on the
    # other rank.
    x = torch.load(tmp_path / "mix_inputs.pt")["images"]
    perm = sample_mix_params(step_generator(0, 3), 8, 0.4, 0.0)["perm"]
    assert any((perm[:4] >= 4).tolist()) or any((perm[4:] < 4).tolist())
    assert x.shape[0] == 8
