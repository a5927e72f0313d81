"""The port's MoE and expert parallelism (``tpunet_torch.models.moe``, the
MoE blocks of the ViT family and the LM) against tpunet's, on the CPU.

- routing: the port's index routing, rebuilt into tpunet's dispatch and
  combine tensors here, equals ``_route`` exactly (E 4, k 1 and 2,
  capacity 0.5 with drops and 2.0);
- the core: ``moe_apply``'s output, aux and the gradients of the tokens,
  the router, wi, bi, wo and bo against tpunet's ``moe_apply`` and
  ``jax.grad`` in float32 at rtol 1e-5 / atol 1e-6;
- the models through ``convert.py``: ViT-MoE (32 px, patch 4, hidden 32,
  depth 2, 2 heads, E 4) and a tiny MoE LM, forward logits at
  tests/test_torch_vit.py's 1e-5, one train step's loss (with the aux)
  and every gradient at tests/test_torch_lm_train.py's 1e-5, and the
  parameters after one Adam step at the sharded tests' bounds;
- tpunet's property tests (tests/test_moe.py:35-90) on the port, the
  dispatch choice with tpunet's cases and messages, the flags parsed to
  tpunet's configuration;
- expert parallelism: gloo gangs at 'model' 2 and 'data' 2 x 'model' 2
  (``tests/_torch_shard_worker.py`` ``moe_m2``/``moe_d2m2``), both
  lowerings, against one rank and against tpunet's shard_map lowerings
  on its 8-device CPU mesh; and the training CLI at 'model' 2 under
  each dispatch and ViT-MoE at data 2 x model 2 with FSDP against the
  port's one-process epoch;
- decoding: the greedy tokens of ``generate`` and of the serving engine
  equal tpunet's ``generate`` for an MoE LM (capacity factor 4 >= E, so
  that nothing drops and a call's routing scope does not matter).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import _torch_gang
import _torch_threads  # noqa: F401
from _torch_port import LM, jax_lm, lm_params, port_lm
from test_torch_seq_train import port_epoch
from test_torch_tp import LM_FLAGS, VIT_FLAGS, check_epoch, check_ranks
from tpunet.compat import shard_map
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import config_from_args as jax_config_from_args
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.models.lm import generate as jax_generate
from tpunet.models.moe import MoeMlp as JaxMoeMlp
from tpunet.models.moe import _route as jax_route
from tpunet.models.moe import moe_apply as jax_moe_apply
from tpunet.models.moe import resolve_moe_dispatch as jax_resolve
from tpunet_torch.config import ModelConfig, ServeConfig
from tpunet_torch.models import create_model, num_params
from tpunet_torch.models.convert import (lm_params_to_jax,
                                         lm_state_dict_from_jax,
                                         load_state_dict,
                                         vit_state_dict_from_jax)
from tpunet_torch.models.lm import generate
from tpunet_torch.models.moe import (capacity, moe_apply,
                                     resolve_moe_dispatch, route)
from tpunet_torch.parallel.tp import layout
from tpunet_torch.serve import Engine
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.state import TrainState, make_optimizer
from tpunet_torch.train.steps import fit_batch, fit_lm_batch

SIZE = 32
VIT_MOE = dict(name="vit", vit_patch=4, vit_hidden=32, vit_depth=2,
               vit_heads=2, dtype="float32", dropout_rate=0.0, moe_experts=4)
E, D, H, N = 4, 16, 32, 64


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _redraw_experts(params, rng):
    """Nonzero expert biases and a router that prefers some experts: the
    init's zero biases and N(0, 0.02) router route almost uniformly."""
    for node in params.values():
        if isinstance(node, dict) and "moe" in node:
            moe = node["moe"]
            moe["bi"] = rng.normal(0, 0.1, moe["bi"].shape).astype(np.float32)
            moe["bo"] = rng.normal(0, 0.1, moe["bo"].shape).astype(np.float32)
            moe["router"]["kernel"] = rng.normal(
                0, 0.3, moe["router"]["kernel"].shape).astype(np.float32)
    return params


def _core_args(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(n, D)).astype(np.float32),
        rw=rng.normal(0, 0.3, (E, D)).astype(np.float32),
        rb=rng.normal(0, 0.1, E).astype(np.float32),
        wi=rng.normal(0, 0.1, (E, D, H)).astype(np.float32),
        bi=rng.normal(0, 0.1, (E, H)).astype(np.float32),
        wo=rng.normal(0, 0.1, (E, H, D)).astype(np.float32),
        bo=rng.normal(0, 0.1, (E, D)).astype(np.float32))


def _jax_core(a, k, cf, impl=None, ep=1):
    """tpunet's value and gradients of sum(y^2) + 0.01 * aux through its
    ``moe_apply`` (unsharded, or ``impl`` under shard_map over an
    ``ep``-wide 'model' axis), in the port's layouts."""
    def core(x, rw, rb, wi, bi, wo, bo):
        return jax_moe_apply(x, x @ rw.T + rb, wi, bi, wo, bo, top_k=k,
                             capacity_factor=cf, dtype=jnp.float32,
                             ep_axis="model" if impl else None,
                             ep_impl=impl or "replicated")

    fn = core
    if impl is not None:
        from jax.sharding import Mesh, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()[:ep]), ("model",))
        fn = shard_map(core, mesh=mesh,
                       in_specs=(P(), P(), P(), P("model"), P("model"),
                                 P("model"), P("model")),
                       out_specs=(P(), P()), check_vma=False)

    def loss(args):
        y, aux = fn(*args)
        return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

    keys = ("x", "rw", "rb", "wi", "bi", "wo", "bo")
    (v, (y, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tuple(jnp.asarray(a[k]) for k in keys))
    return dict(v=float(v), y=np.asarray(y), aux=float(aux),
                grads={k: np.asarray(gi) for k, gi in zip(keys, g)})


def _port_core(a, k, cf):
    t = {key: torch.from_numpy(v.copy()).requires_grad_()
         for key, v in a.items()}
    y, aux = moe_apply(t["x"], t["rw"], t["rb"], t["wi"], t["bi"], t["wo"],
                       t["bo"], num_experts=E, top_k=k, capacity_factor=cf,
                       dtype=torch.float32)
    v = (y ** 2).sum() + 0.01 * aux
    v.backward()
    return dict(v=v.item(), y=y.detach().numpy(), aux=aux.item(),
                grads={key: p.grad.numpy() for key, p in t.items()})


def _close(got, want, rtol=1e-5, atol=1e-6, tag=""):
    np.testing.assert_allclose(got["y"], want["y"], rtol=rtol, atol=atol,
                               err_msg=f"{tag} y")
    assert got["aux"] == pytest.approx(want["aux"], rel=rtol, abs=atol), tag
    for key, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][key], g, rtol=rtol,
                                   atol=atol, err_msg=f"{tag} d{key}")


# ---------------------------------------------------------------------------
# routing and the core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_routing_equals_tpunet_route(k, factor):
    rng = np.random.default_rng(k * 10 + int(factor * 2))
    probs = np.array(jax.nn.softmax(jnp.asarray(
        rng.normal(0, 1.5, (N, E)), jnp.float32), -1))
    cap = capacity(k, N, E, factor)
    assert cap == max(k, math.ceil(k * N / E * factor))
    want_d, want_c = (np.asarray(a) for a in jax_route(
        jnp.asarray(probs), k, E, cap))
    r = route(torch.from_numpy(probs), k, E, cap)
    kept = r.kept.numpy()
    tok, ex, pos = (a.numpy()[kept] for a in (r.token, r.expert, r.pos))
    got_d = np.zeros((N, E, cap), np.float32)
    got_c = np.zeros((N, E, cap), np.float32)
    got_d[tok, ex, pos] = 1.0
    got_c[tok, ex, pos] = r.gate.numpy()[kept]
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(r.counts.numpy(), want_d.sum((0, 2)))
    if factor < 1:
        assert kept.sum() < k * N            # the case drops pairs


@pytest.mark.parametrize("k,factor", [(1, 0.5), (2, 0.5), (2, 1.25),
                                      (2, 8.0)])
def test_moe_apply_and_its_gradients_match_tpunet(k, factor):
    a = _core_args(1)
    _close(_port_core(a, k, factor), _jax_core(a, k, factor),
           tag=f"k{k} f{factor}")


# ---------------------------------------------------------------------------
# tpunet's property tests (tests/test_moe.py:35-90) on the port
# ---------------------------------------------------------------------------


def _port_mlp(experts=4, top_k=2, cap=1.25, dtype=torch.float32):
    """tpunet's ``_moe`` fixture's MoeMlp ([2, 16, 32] tokens, hidden
    128) and input, through the port's block arithmetic."""
    from tpunet_torch.models.vit import ViT
    model = ViT(image_size=4, patch_size=4, hidden=32, depth=1, heads=2,
                mlp_ratio=4.0, dtype=dtype, moe_experts=experts,
                moe_every=1, moe_top_k=top_k, moe_capacity_factor=cap)
    moe = model.blocks[0].moe
    moe.init_(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 32)).astype(np.float32)).to(dtype)
    return model, moe, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_shape_and_dtype(dtype):
    model, moe, x = _port_mlp(dtype=dtype)
    y = model._moe(moe, x, False, None)
    assert y.shape == x.shape and y.dtype == x.dtype


def test_output_finite_with_ample_capacity():
    model, moe, x = _port_mlp(cap=4.0)
    assert bool(torch.isfinite(model._moe(moe, x, False, None)).all())


def test_aux_loss_collected_and_bounded():
    model, moe, x = _port_mlp(cap=4.0)
    aux = []
    model._moe(moe, x, True, aux)
    assert len(aux) == 1
    # Perfectly balanced routing gives exactly 1.0; anything else > 1.
    assert 1.0 - 1e-5 <= aux[0].item() < moe.num_experts + 1e-5


def test_single_expert_topk1_is_dense_mlp_through_router():
    model, moe, x = _port_mlp(experts=1, top_k=1, cap=8.0)
    y = model._moe(moe, x, False, None)
    h = F.gelu(x @ moe.wi[0] + moe.bi[0], approximate="tanh")
    ref = h @ moe.wo[0] + moe.bo[0]
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_capacity_drops_tokens_but_stays_finite():
    model, moe, x = _port_mlp(cap=0.1)
    assert bool(torch.isfinite(model._moe(moe, x, False, None)).all())


def test_moe_mlp_matches_tpunet_module():
    """tpunet's MoeMlp fixture (its init, [2, 16, 32] tokens) against the
    port's MoE block on its weights: output and aux."""
    m = JaxMoeMlp(4, 128, top_k=2, capacity_factor=1.25, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 16, 32)).astype(np.float32)
    p = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want, mut = m.apply({"params": p}, jnp.asarray(x), mutable=["losses"])
    (want_aux,) = jax.tree_util.tree_leaves(mut["losses"])
    model, moe, _ = _port_mlp()
    with torch.no_grad():
        moe.router.weight.copy_(torch.from_numpy(p["router"]["kernel"].T))
        moe.router.bias.copy_(torch.from_numpy(p["router"]["bias"]))
        for k in ("wi", "bi", "wo", "bo"):
            getattr(moe, k).copy_(torch.from_numpy(p[k]))
    aux = []
    got = model._moe(moe, torch.from_numpy(x), True, aux)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert aux[0].item() == pytest.approx(float(want_aux), rel=1e-6)


# ---------------------------------------------------------------------------
# the dispatch choice, the flags, the configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    ("auto", 1, 64, 4), ("auto", 2, 64, 4), ("auto", 2, 63, 4),
    ("auto", 4, 64, 6), ("replicated", 4, 64, 4), ("alltoall", 2, 64, 4),
    ("alltoall", 2, 63, 4), ("alltoall", 1, 64, 4), ("nope", 2, 64, 4)],
    ids=lambda a: "-".join(map(str, a)))
def test_resolve_moe_dispatch_equals_tpunet(args):
    dispatch, ep, n, e = args
    kw = dict(ep=ep, n_tokens=n, n_experts=e)
    try:
        want = jax_resolve(dispatch, **kw)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            resolve_moe_dispatch(dispatch, **kw)
        assert str(got.value) == str(err)
        return
    assert resolve_moe_dispatch(dispatch, **kw) == want


@pytest.mark.parametrize("argv", [
    ["--model", "vit", "--moe-experts", "8"],
    ["--model", "lm", "--dataset", "synthetic_lm", "--moe-experts", "4",
     "--moe-top-k", "1", "--moe-every", "3", "--moe-capacity-factor", "2.5",
     "--moe-aux-weight", "0.05", "--moe-dispatch", "alltoall",
     "--mesh-model", "2"],
    ["--model", "vit_base", "--moe-experts", "8", "--moe-dispatch",
     "replicated", "--attention", "ring", "--mesh-seq", "2"]],
    ids=["vit", "lm_all", "vit_base_ring"])
def test_moe_flags_parse_to_tpunet_config(argv):
    got, _ = cli.config_from_args(argv)
    want = jax_config_from_args(argv)
    for f in dataclasses.fields(got.model):
        if f.name.startswith("moe_"):
            assert getattr(got.model, f.name) == getattr(want.model, f.name)
    assert got.mesh.model == want.mesh.model


def test_moe_config_refusals():
    with pytest.raises(ValueError, match="unknown moe_dispatch"):
        ModelConfig(name="vit", moe_dispatch="dense")
    with pytest.raises(ValueError, match="mobilenet_v2"):
        ModelConfig(moe_experts=4)
    with pytest.raises(ValueError, match="whole\nsuper-layers|whole "
                       "super-layers"):
        create_model(ModelConfig(name="lm_pp", moe_experts=4, vit_depth=3,
                                 vit_hidden=32, vit_heads=2), device="cpu")
    with pytest.raises(ValueError, match="moe_every must be >= 1"):
        create_model(ModelConfig(moe_every=0, **VIT_MOE), device="cpu",
                     image_size=SIZE)


# ---------------------------------------------------------------------------
# the models through convert.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_moe():
    model = jax_create_model(JaxModelConfig(attention="dense", **VIT_MOE))
    v = jax.jit(lambda key: init_variables(model, key, image_size=SIZE))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = _redraw_experts(_np(v["params"]), rng)
    params["classifier"]["kernel"] = rng.normal(
        0.0, 0.5, params["classifier"]["kernel"].shape).astype(np.float32)
    port = create_model(ModelConfig(**VIT_MOE), device="cpu",
                        image_size=SIZE)
    assert load_state_dict(port, vit_state_dict_from_jax(params))
    return model, params, port


def test_vit_moe_weights_carry_across(vit_moe):
    _, params, port = vit_moe
    sd = vit_state_dict_from_jax(params)
    assert set(sd) == set(port.state_dict())
    assert "blocks.0.mlp.fc1.weight" in sd and "blocks.1.moe.wi" in sd
    assert "blocks.1.mlp.fc1.weight" not in sd
    assert num_params(port) == sum(a.size for a in
                                   jax.tree_util.tree_leaves(params))
    np.testing.assert_array_equal(
        sd["blocks.1.moe.router.weight"].numpy(),
        params["block01"]["moe"]["router"]["kernel"].T)


def test_vit_moe_logits_match_tpunet(vit_moe):
    model, params, port = vit_moe
    x = np.random.default_rng(1).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _adam_reference(apply_loss, params, lr):
    """tpunet's loss (CE + its weighted aux), gradients and parameters
    after one Adam step (optax, tpunet's optimizer) from ``params``."""
    loss, grads = jax.jit(jax.value_and_grad(apply_loss))(params)
    tx = optax.adam(lr)
    upd, _ = tx.update(grads, tx.init(params), params)
    return float(loss), _np(grads), _np(optax.apply_updates(params, upd))


def _check_step(got_loss, want_loss, port, want_grads, want_params,
                grads_before):
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    gmax = max(float(g.abs().max()) for g in want_grads.values())
    assert gmax > 1e-2
    for key, g in grads_before.items():
        err = float((g - want_grads[key]).abs().max())
        assert err <= 1e-5 * gmax, (key, err, gmax)
    sd = port.state_dict()
    for key, w in want_params.items():
        got = sd[key].numpy()
        w = w.numpy()
        if key.endswith("attn.qkv.bias"):
            # The key bias's exact gradient is 0: Adam turns its rounding
            # noise into full steps in either package (tests/test_torch_tp.py).
            got, w = got.reshape(3, -1)[[0, 2]], w.reshape(3, -1)[[0, 2]]
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-5,
                                   err_msg=key)


def test_vit_moe_train_step_matches_tpunet(vit_moe):
    """One step: tpunet's CE + 0.01 * the sown aux, its gradients and
    Adam; the port's ``fit_batch`` with ``aux_weight`` 0.01."""
    from tpunet_torch.config import OptimConfig
    model, params, _ = vit_moe
    x = np.random.default_rng(2).standard_normal(
        (8, SIZE, SIZE, 3)).astype(np.float32)
    y = np.arange(8) % 10
    lr = 1e-3

    def loss_fn(p):
        logits, mut = model.apply({"params": p}, jnp.asarray(x), train=True,
                                  mutable=["losses"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32)).mean()
        return ce + 0.01 * sum(jax.tree_util.tree_leaves(mut["losses"]))

    jloss, jgrads, jparams = _adam_reference(loss_fn, params, lr)
    port = create_model(ModelConfig(**VIT_MOE), device="cpu",
                        image_size=SIZE)
    load_state_dict(port, vit_state_dict_from_jax(params))
    optim = OptimConfig(learning_rate=lr)
    state = TrainState(port, make_optimizer(port.parameters(), optim),
                       lambda t: lr)
    grads = {}
    real = state.apply_gradients

    def apply():
        grads.update({k: p.grad.clone() for k, p in port.named_parameters()})
        real()
    state.apply_gradients = apply
    m = fit_batch(state, torch.from_numpy(x), torch.from_numpy(y),
                  torch.Generator(), optim, aux_weight=0.01)
    _check_step(float(m["loss_sum"]) / 8, jloss, port,
                vit_state_dict_from_jax(jgrads), vit_state_dict_from_jax(
                    jparams), grads)


@pytest.fixture(scope="module")
def lm_moe():
    params = _redraw_experts(lm_params(3, moe_experts=4),
                             np.random.default_rng(3))
    return params, port_lm(params, moe_experts=4)


def test_lm_moe_logits_and_round_trip(lm_moe):
    params, port = lm_moe
    tokens = np.random.default_rng(4).integers(0, LM["vocab_size"], (2, 24))
    want = np.asarray(jax_lm(moe_experts=4).apply(
        {"params": params}, jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = lm_params_to_jax(port.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lm_moe_train_step_matches_tpunet(lm_moe, remat):
    """One ``fit_lm_batch`` (Adam, aux weight 0.01) against tpunet's
    CE mean + aux, its gradients and Adam; under ``--remat`` the aux is
    an output of the checkpointed blocks and the step is the same."""
    from tpunet_torch.config import OptimConfig
    params, _ = lm_moe
    tokens = np.random.default_rng(5).integers(
        0, LM["vocab_size"], (8, 32)).astype(np.int32)
    lr = 1e-3
    model = jax_lm(moe_experts=4)

    def loss_fn(p):
        lg, mut = model.apply({"params": p}, jnp.asarray(tokens), train=True,
                              mutable=["losses"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            lg[:, :-1], jnp.asarray(tokens)[:, 1:]).mean()
        return ce + 0.01 * sum(jax.tree_util.tree_leaves(mut["losses"]))

    jloss, jgrads, jparams = _adam_reference(loss_fn, params, lr)
    port = port_lm(params, moe_experts=4)
    port.remat = remat
    optim = OptimConfig(learning_rate=lr)
    state = TrainState(port, make_optimizer(port.parameters(), optim),
                       lambda t: lr)
    grads = {}
    real = state.apply_gradients

    def apply():
        grads.update({k: p.grad.clone() for k, p in port.named_parameters()})
        real()
    state.apply_gradients = apply
    m = fit_lm_batch(state, torch.from_numpy(tokens), torch.from_numpy(tokens),
                     torch.Generator(), optim, aux_weight=0.01)
    _check_step(float(m["loss_sum"] / m["count"]), jloss, port,
                lm_state_dict_from_jax(jgrads),
                lm_state_dict_from_jax(jparams), grads)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


def test_greedy_generate_and_engine_equal_tpunet(lm_moe):
    """Capacity factor 4 >= E: nothing drops, so tpunet's full-forward
    generate, the port's, and the engine's [slots, 1] decode steps and
    bucketed prefills give the same greedy tokens."""
    params, _ = lm_moe
    cfg = dict(moe_experts=4, moe_capacity_factor=4.0)
    port = port_lm(params, **cfg)
    prompt = np.array([[5, 9, 2, 17, 3], [1, 1, 40, 8, 63]], np.int32)
    want = np.asarray(jax_generate(jax_lm(**cfg), {"params": params},
                                   jnp.asarray(prompt), n_new=12))
    got = generate(port, torch.from_numpy(prompt), 12).numpy()
    np.testing.assert_array_equal(got, want)
    eng = Engine(port, ServeConfig(slots=3, prefill_buckets=(8, 16),
                                   emit_every_s=0.0)).start()
    try:
        reqs = [eng.submit(row, max_new_tokens=12) for row in prompt]
        streams = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    for row, stream in zip(want, streams):
        assert stream == row[prompt.shape[1]:].tolist()


def test_generate_and_serve_clis_take_moe(capsys):
    from tpunet_torch.infer import generate as gen_cli
    from tpunet_torch.serve.__main__ import build_argparser, build_server
    flags = ["--vit-hidden", "32", "--vit-depth", "2", "--vit-heads", "2",
             "--max-seq-len", "48", "--moe-experts", "4"]
    gen_cli.main(["--device", "cpu", "--checkpoint-dir", "",
                  "--prompt", "The ", "--tokens", "4", *flags])
    assert capsys.readouterr().out.startswith("The ")
    server = build_server(build_argparser().parse_args(
        ["--checkpoint-dir", "", "--device", "cpu", "--prefill-buckets",
         "16", "--port", "0", *flags]))
    blocks = server.engine.model.blocks
    assert hasattr(blocks[1], "moe") and not hasattr(blocks[0], "moe")


# ---------------------------------------------------------------------------
# expert parallelism: gloo gangs
# ---------------------------------------------------------------------------

FACTORS = (8.0, 0.5)
MOE_LM_FLAGS = LM_FLAGS + ["--moe-experts", "4", "--moe-capacity-factor",
                           "4", "--batch-size", "8"]
MOE_VIT_FLAGS = VIT_FLAGS + ["--moe-experts", "4", "--moe-capacity-factor",
                             "4"]


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    a = _core_args(7)
    np.savez(d / "moe_ep.npz", factors=np.array(FACTORS), **a)
    flags = {
        "moe_lm_a2a": MOE_LM_FLAGS + ["--mesh-model", "2", "--moe-dispatch",
                                      "alltoall"],
        "moe_lm_rep": MOE_LM_FLAGS + ["--mesh-model", "2", "--moe-dispatch",
                                      "replicated"],
        "moe_vit_fsdp": ["--preset", "distributed"] + MOE_VIT_FLAGS + [
            "--batch-size", "8", "--mesh-data", "2", "--mesh-model", "2",
            "--moe-dispatch", "alltoall", "--fsdp"]}
    (d / "flags.json").write_text(json.dumps(flags))
    running = [(2, _torch_gang.start(d, 2, ["moe_m2", "moe_lm_a2a",
                                            "moe_lm_rep"], tag="m2")),
               (4, _torch_gang.start(d, 4, ["moe_d2m2", "moe_vit_fsdp"],
                                     tag="d2m2"))]
    want = {"moe_lm": port_epoch(MOE_LM_FLAGS[2:], d, "moe_lm_w1"),
            "moe_vit": port_epoch(MOE_VIT_FLAGS + ["--batch-size", "16"], d,
                                  "moe_vit_w1")}
    for world, gang in running:
        _torch_gang.wait(d, world, gang)
    got = {name: [torch.load(d / f"{name}_rank{r}.pt", weights_only=False)
                  for r in range(world)]
           for world, names in ((2, ("moe_m2", "moe_lm_a2a", "moe_lm_rep")),
                                (4, ("moe_d2m2", "moe_vit_fsdp")))
           for name in names}
    return dict(d=d, args=a, want=want, got=got)


def _joined(dumps, key, data, model):
    """The gradients of a gang's ranks as one rank's: experts joined over
    'model', tokens joined over 'data', everything summed over 'data'
    (rank r is data r // model, model r % model)."""
    out = {}
    for k in ("x", "rw", "rb", "wi", "bi", "wo", "bo"):
        per_data = []
        for di in range(data):
            ranks = [dumps[di * model + j][key]["grads"][k]
                     for j in range(model)]
            if k in ("wi", "bi", "wo", "bo"):
                e = ranks[0].shape[0] // model
                per_data.append(torch.cat([g[j * e:(j + 1) * e]
                                           for j, g in enumerate(ranks)]))
            else:
                for g in ranks[1:]:
                    assert torch.equal(g, ranks[0]), (k, key)
                per_data.append(ranks[0])
        out[k] = sum(per_data).numpy()
    return out


@pytest.mark.parametrize("impl", ["replicated", "alltoall"])
@pytest.mark.parametrize("mesh", ["m2", "d2m2"])
def test_expert_parallel_core_matches_one_rank_and_tpunet(gangs, mesh,
                                                          impl):
    """Ample capacity: every rank's output, the aux term and the joined
    gradients against the port on one rank, tpunet unsharded and
    tpunet's shard_map lowering at the same 'model' width."""
    data, model = (1, 2) if mesh == "m2" else (2, 2)
    dumps = gangs["got"][f"moe_{mesh}"]
    a, key = gangs["args"], (impl, FACTORS[0])
    one = _port_core(a, 2, FACTORS[0])
    ref = _jax_core(a, 2, FACTORS[0])
    sharded = _jax_core(a, 2, FACTORS[0], impl=impl, ep=model)
    n = a["x"].shape[0] // data
    y = np.concatenate([dumps[di * model][key]["y"].numpy()
                        for di in range(data)])
    for r, dump in enumerate(dumps):
        assert float(dump[key]["aux"]) == pytest.approx(one["aux"],
                                                        rel=1e-6)
        di = r // model
        np.testing.assert_allclose(dump[key]["y"].numpy(),
                                   one["y"][di * n:(di + 1) * n],
                                   rtol=1e-5, atol=1e-6)
    got = dict(y=y, aux=float(dumps[0][key]["aux"]),
               grads=_joined(dumps, key, data, model))
    for want, tag in ((one, "one rank"), (ref, "tpunet"),
                      (sharded, "tpunet shard_map")):
        _close(got, want, rtol=1e-4, atol=1e-6, tag=f"{mesh} {impl} {tag}")


def test_alltoall_drops_match_tpunet_shard_map(gangs):
    """Capacity 0.5 at 'model' 2: the a2a lowering routes each half of
    the tokens at the half's capacity in both packages, so the drops are
    the same; the replicated lowering routes all tokens as one rank."""
    dumps, a = gangs["got"]["moe_m2"], gangs["args"]
    cf = FACTORS[1]
    for impl, want in (("alltoall", _jax_core(a, 2, cf, "alltoall", 2)),
                       ("replicated", _port_core(a, 2, cf))):
        got = dict(y=dumps[0][(impl, cf)]["y"].numpy(),
                   aux=float(dumps[0][(impl, cf)]["aux"]),
                   grads=_joined(dumps, (impl, cf), 1, 2))
        _close(got, want, rtol=1e-4, atol=1e-6, tag=impl)


@pytest.mark.parametrize("name,ref,mesh", [
    ("moe_lm_a2a", "moe_lm", dict(data=1, seq=1, pipe=1, model=2)),
    ("moe_lm_rep", "moe_lm", dict(data=1, seq=1, pipe=1, model=2)),
    ("moe_vit_fsdp", "moe_vit", dict(data=2, seq=1, pipe=1, model=2))])
def test_expert_parallel_epoch_matches_one_process(gangs, name, ref, mesh):
    """The CLI's epoch with the experts split over 'model' against the
    port's one-process epoch: the epoch record and the parameters at the
    sharded tests' bounds, the replicated leaves (the routers among
    them) equal on every rank with no gap between the ranks' gradients,
    the expert pieces joined into the saved whole."""
    dumps = gangs["got"][name]
    whole = torch.load(gangs["d"] / f"ck_{name}" / "state.pt")["model"]
    cfg = ModelConfig(name="lm" if ref == "moe_lm" else "vit")
    table = layout({k: tuple(v.shape) for k, v in whole.items()}, cfg, mesh,
                   fsdp=name.endswith("fsdp"))
    assert table["blocks.1.moe.wi"].param.axis == "model"
    assert table["blocks.1.moe.router.weight"].param is None or \
        table["blocks.1.moe.router.weight"].param.axis == "data"
    for dump in dumps:
        check_epoch(dump["history"], whole, gangs["want"][ref], name)
    check_ranks(dumps, whole, table, mesh)
