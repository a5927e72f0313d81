"""Parameter EMA of the port against tpunet's, on the CPU.

- Three SGD steps (rate 1e-3) of train-mode MobileNetV2
  (tests/_torch_port.py's ``train_variables`` seed 2, the train-mode
  parity test's 8 images, dropout 0) with ``ema_decay``
  0.9 through tpunet's ``_steps_from_micro`` and the port's
  ``fit_batch``: the EMA parameters and BN statistics agree within the
  tolerances of the train-mode parity test's running statistics (rtol
  1e-3, atol 1e-4; tests/test_torch_train.py), and, to float32 rounding
  (rtol 1e-6), with tpunet's formula ``e = d*e + (1-d)*p`` run over the
  port's own post-update values from the initial copy.
- The Trainer: eval reads the EMA pair, ``best.pth`` holds it, and the
  EMA survives ``--resume`` to the bit; ``ema_decay`` outside [0, 1) is
  refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.models import create_model as jax_create_model
from tpunet.train.state import TrainState as JaxTrainState
from tpunet.train.steps import _steps_from_micro
from tpunet.train import metrics as JM
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 OptimConfig, TrainConfig)
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict, state_dict_from_jax
from tpunet_torch.train.loop import Trainer
from tpunet_torch.train.state import TrainState
from tpunet_torch.train.steps import fit_batch

from _torch_port import SIZE, WIDTH, train_variables
import _torch_threads  # noqa: E402,F401

DECAY = 0.9
EPS32 = float(np.finfo(np.float32).eps)
LR = 1e-5


def _batches():
    """The train-mode parity test's batch (input seed 9, labels 0..7),
    three times: at random init train-mode BN amplifies the last bits of
    its sums by an amount that depends on the inputs, and on this batch
    the two packages' gradients agree within 1e-3 of the largest."""
    x = np.random.default_rng(9).standard_normal(
        (8, SIZE, SIZE, 3)).astype(np.float32)
    return [(x, np.arange(8, dtype=np.int32))] * 3


@pytest.fixture(scope="module")
def three_steps():
    params, stats = train_variables(seed=2)
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH,
                                             dropout_rate=0.0))

    def micro(p, bs, apply_fn, x, y, rng):
        def loss_fn(pp):
            logits, mut = apply_fn({"params": pp, "batch_stats": bs}, x,
                                   train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), mut["batch_stats"]
        (loss, new), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return g, new, JM.from_batch(loss * 8, 0, 8)

    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=params, batch_stats=stats,
        ema_params=copy(params), ema_batch_stats=copy(stats),
        tx=optax.sgd(LR))
    step = jax.jit(_steps_from_micro(micro, 1, None, ema_decay=DECAY))
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                     dropout_rate=0.0,
                                     use_pallas_depthwise=True),
                         device="cpu")
    assert load_state_dict(model, state_dict_from_jax(params, stats))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR),
                       lambda t: LR, ema_decay=DECAY)
    # tpunet's EMA formula over the port's own post-update values.
    formula = [t.detach().numpy().copy() for t in state.ema_sources()]
    for x, y in _batches():
        jstate, _ = step(jstate, jnp.asarray(x), jnp.asarray(y),
                         jax.random.PRNGKey(0))
        fit_batch(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                  torch.Generator(), OptimConfig(name="sgd"))
        formula = [np.asarray(DECAY * jnp.asarray(e) + (1.0 - DECAY)
                              * jnp.asarray(p.detach().numpy()))
                   for e, p in zip(formula, state.ema_sources())]
    want = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.ema_params),
        jax.tree_util.tree_map(np.asarray, jstate.ema_batch_stats))
    return state, want, formula, state_dict_from_jax(params, stats)


def test_ema_after_three_steps_matches_tpunets(three_steps):
    state, want, _, start = three_steps
    with state.ema_weights():
        got = state.model.state_dict()
    n = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            # How far the EMA moved from the initial weights, against
            # tpunet's, to 5% of tpunet's largest move a tensor, plus the
            # float32 rounding of the weights themselves.
            moved, want_moved = v - start[k], want[k] - start[k]
            err = float((moved - want_moved).abs().max())
            rounding = 4 * EPS32 * float(start[k].abs().max())
            assert err <= 5e-2 * float(want_moved.abs().max()) + rounding, k
        n += 1
    assert n == 158 + 2 * 52


def test_ema_is_tpunets_formula_over_post_update_values(three_steps):
    state, _, formula, _ = three_steps
    assert len(state.ema) == len(formula) == 158 + 2 * 52
    for e, f in zip(state.ema, formula):
        np.testing.assert_allclose(e.numpy(), f, rtol=1e-6, atol=1e-7)


def test_ema_weights_swaps_in_and_back(three_steps):
    state = three_steps[0]
    live = [t.detach().clone() for t in state.ema_sources()]
    with state.ema_weights():
        assert all(torch.equal(t, e) for t, e in
                   zip(state.ema_sources(), state.ema))
    assert all(torch.equal(t, v) for t, v in zip(state.ema_sources(), live))
    assert not all(torch.equal(t, e) for t, e in zip(live, state.ema))


# -- the Trainer ---------------------------------------------------------------


def _cfg(directory, epochs=2, resume=False, decay=DECAY):
    return TrainConfig(
        epochs=epochs, seed=5,
        data=DataConfig(dataset="synthetic", image_size=SIZE, batch_size=16,
                        synthetic_train_size=48, synthetic_test_size=20),
        model=ModelConfig(dtype="float32", width_mult=WIDTH,
                          use_pallas_depthwise=True),
        optim=OptimConfig(ema_decay=decay, learning_rate=1e-3),
        checkpoint=CheckpointConfig(directory=str(directory), resume=resume))


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ema")
    trainer = Trainer(_cfg(d), device="cpu")
    history = trainer.train()
    trainer.close()
    return d, trainer, history


def test_eval_reads_the_ema_pair(two_epochs):
    _, trainer, history = two_epochs
    fresh = create_model(trainer.cfg.model, device="cpu")
    with trainer.state.ema_weights():
        fresh.load_state_dict(trainer.state.model.state_dict())
    plain = Trainer(dataclasses.replace(
        trainer.cfg, optim=OptimConfig(learning_rate=1e-3),
        checkpoint=CheckpointConfig(directory=trainer.cfg.checkpoint.directory
                                    + "_plain")), device="cpu")
    try:
        plain.state.model.load_state_dict(fresh.state_dict())
        want = plain.evaluate()
    finally:
        plain.close()
    got = trainer.evaluate()
    assert got == want
    assert history[-1]["test_loss"] == got["loss"]
    live = trainer._evaluate()
    assert live["loss"] != got["loss"]


def test_best_pth_holds_the_ema_pair(two_epochs):
    d, trainer, history = two_epochs
    best = max(range(len(history)), key=lambda i: history[i]["test_accuracy"])
    assert history[best]["test_accuracy"] > 0
    sd = torch.load(d / "best.pth", weights_only=True)
    if best == len(history) - 1:
        with trainer.state.ema_weights():
            want = trainer.state.model.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sd[k], v), k
    # --eval-only reads best.pth as the EMA pair: the best epoch's metrics.
    again = Trainer(dataclasses.replace(_cfg(d), eval_only=True),
                    device="cpu")
    try:
        m = again.evaluate_checkpoint()
    finally:
        again.close()
    assert m["accuracy"] == history[best]["test_accuracy"]
    assert m["loss"] == history[best]["test_loss"]


def test_ema_survives_resume_to_the_bit(two_epochs, tmp_path):
    _, full, history = two_epochs
    first = Trainer(_cfg(tmp_path, epochs=1), device="cpu")
    first.train()
    first.close()
    resumed = Trainer(_cfg(tmp_path, epochs=2, resume=True), device="cpu")
    try:
        h2 = resumed.train()
    finally:
        resumed.close()
    assert h2[0]["test_loss"] == history[1]["test_loss"]
    for a, b in zip(full.state.ema, resumed.state.ema):
        assert torch.equal(a, b)


@pytest.mark.parametrize("decay", [1.0, -0.1, 1.5])
def test_ema_decay_outside_zero_one_is_refused(tmp_path, decay):
    with pytest.raises(ValueError, match=r"ema_decay must be in \[0, 1\)"):
        Trainer(_cfg(tmp_path, decay=decay), device="cpu")
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                         device="cpu")
    with pytest.raises(ValueError, match="ema_decay"):
        TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1),
                   lambda t: 0.1, ema_decay=decay)


def test_ema_off_keeps_no_copies():
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                         device="cpu")
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1),
                       lambda t: 0.1)
    assert state.ema is None
    x = torch.randn(2, 3, SIZE, SIZE)
    with state.ema_weights():
        a = model(x)
    assert torch.equal(a, model(x))
    F.softmax(a, -1)
