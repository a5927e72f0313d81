"""Tensor parallelism of the port (the mesh's 'model' axis) against
tpunet, on the CPU.

- The rule table (``tpunet_torch.parallel.tp``) mirrors
  tests/test_tp.py:22-78: the Megatron rules for the ViT family and the
  LM and none for MobileNetV2; qkv/fc1 column-parallel, out/fc2
  row-parallel, positions and norms replicated, the moments split as
  their parameters; an indivisible dim falls back to replication; with
  ZeRO-1 the TP rules win for matched moments and ZeRO-1 takes the
  rest. The per-head qkv split: the pieces of the port's qkv weight are
  each rank's heads of q, k and v of tpunet's kernel, and joined they
  are tpunet's kernel exactly.
- On 2 gloo ranks (``tests/_torch_shard_worker.py``, one process a rank):
  a tiny ViT (4 heads, tpunet's weights, dropout 0) cut over the
  'model' axis, one train-mode forward/backward against tpunet's
  ``jax.value_and_grad`` on the same images: the loss to 1e-5
  relative, the logits to 1e-5, every gathered gradient within 1e-5 of
  the largest. Then ``python -m tpunet_torch.train --preset distributed
  --mesh-model 2`` for one epoch: the LM (from tpunet's initial
  weights, ``--pretrained``, vocab 32: the CE is vocab-parallel) against
  tpunet's Trainer on its CPU mesh at data 2, and the ViT against the
  port's one-process epoch (its augmentation draws from torch's
  generator, not JAX's): train loss within 1e-4, test accuracy within
  1e-6 (tests/test_tp.py:84-86), parameters within rtol 2e-4 / atol
  2e-5 (tests/test_fsdp.py:150-156), but for the key third of the qkv
  bias, whose exact gradient is 0, so that Adam moves it by rounding
  noise scaled to lr in either package; the replicated leaves equal to the
  bit on both ranks, and the ranks' pieces joined equal to the whole
  parameters rank 0 saved. At dropout 0.2 the LM's TP epoch equals the
  one-process epoch at the same bounds: the masks lie on replicated
  activations and are seeded from the data index.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpunet.config import CheckpointConfig as JaxCheckpointConfig
from tpunet.config import DataConfig as JaxDataConfig
from tpunet.config import MeshConfig as JaxMeshConfig
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import OptimConfig as JaxOptimConfig
from tpunet.config import TrainConfig as JaxTrainConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.parallel.tp import VIT_TP_RULES as JAX_VIT_TP_RULES
from tpunet.train.loop import Trainer as JaxTrainer
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import (lm_state_dict_from_jax,
                                         vit_state_dict_from_jax)
from tpunet_torch.parallel.tp import (VIT_TP_RULES, ZERO1_RULES, Shard,
                                      _spec_for, join, layout, pieces,
                                      rules_for)
from tpunet_torch.train import __main__ as cli

import _torch_gang
import _torch_threads  # noqa: F401

WORLD = 2
SIZE = 32
VIT = dict(name="vit", vit_patch=4, vit_hidden=64, vit_depth=2, vit_heads=4,
           dtype="float32", dropout_rate=0.0)
LM = dict(name="lm", vit_hidden=64, vit_depth=2, vit_heads=4, vocab_size=32,
          max_seq_len=32, dtype="float32", dropout_rate=0.0)
LM_DATA = dict(dataset="synthetic_lm", batch_size=8, synthetic_train_size=32,
               synthetic_test_size=8, seq_len=32, vocab_size=32)
LM_LR = 1e-3     # tests/test_fsdp.py:37 parity runs use 1e-3 with these bounds
LM_FLAGS = ["--preset", "distributed", "--device", "cpu", "--model", "lm",
            "--dataset", "synthetic_lm", "--vit-hidden", "64", "--vit-depth",
            "2", "--vit-heads", "4", "--vocab-size", "32", "--seq-len", "32",
            "--max-seq-len", "32", "--synthetic-size", "32", "--dtype",
            "float32", "--dropout-rate", "0", "--lr", str(LM_LR),
            "--epochs", "1", "--no-obs", "--no-native-loader"]
VIT_FLAGS = ["--device", "cpu", "--model", "vit", "--vit-patch", "4",
             "--vit-hidden", "64", "--vit-depth", "2", "--vit-heads", "4",
             "--dataset", "synthetic", "--synthetic-size", "32",
             "--image-size", "32", "--dtype", "float32", "--dropout-rate",
             "0", "--lr", "1e-3", "--epochs", "1", "--no-obs",
             "--no-native-loader"]
# tests/test_tp.py:84-86 and tests/test_fsdp.py:150-156.
LOSS_TOL, ACC_TOL = 1e-4, 1e-6
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
MESH = {"data": 1, "seq": 1, "pipe": 1, "model": 2}


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v, np.float32)
            for k, v in tree.items()}


def jax_vit_params():
    """tpunet's tiny ViT params with LayerNorms, biases and the head
    redrawn from numpy (Flax's init gives a zero head)."""
    model = jax_create_model(JaxModelConfig(attention="dense", **VIT))
    v = jax.jit(lambda key: init_variables(model, key, image_size=SIZE))(
        jax.random.PRNGKey(0))
    params = _plain(v["params"])
    rng = np.random.default_rng(0)

    def redraw(tree):
        for node in tree.values():
            if not isinstance(node, dict):
                continue
            if "scale" in node:
                node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape
                                            ).astype(np.float32)
            if "bias" in node:
                node["bias"] = rng.normal(0.0, 0.1, node["bias"].shape
                                          ).astype(np.float32)
            redraw(node)

    redraw(params)
    params["classifier"]["kernel"] = rng.normal(
        0.0, 0.5, params["classifier"]["kernel"].shape).astype(np.float32)
    return model, params


def jax_lm_trainer(mesh_data: int, **optim) -> JaxTrainer:
    """tpunet's Trainer of the LM runs at a data-only mesh (``optim``:
    more fields of its OptimConfig)."""
    return JaxTrainer(JaxTrainConfig(
        epochs=1, data=JaxDataConfig(**LM_DATA),
        model=JaxModelConfig(**LM),
        optim=JaxOptimConfig(learning_rate=LM_LR, **optim),
        mesh=JaxMeshConfig(data=mesh_data),
        checkpoint=JaxCheckpointConfig(save_best=False, save_last=False)))


def jax_lm_start(mesh_data: int, d, **optim) -> JaxTrainer:
    """tpunet's LM Trainer, its initial weights written to ``d/lm.pth``
    in the port's layout for the port's ``--pretrained``."""
    trainer = jax_lm_trainer(mesh_data, **optim)
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(trainer.state.params))
    torch.save(lm_state_dict_from_jax(init), d / "lm.pth")
    return trainer


def jax_lm_epoch(trainer: JaxTrainer) -> dict:
    """The epoch of :func:`jax_lm_start`'s Trainer, then closed; with
    EMA on, its EMA parameters too."""
    host = lambda tree: lm_state_dict_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, jax.device_get(tree)))
    try:
        train = trainer.train_one_epoch(1)
        test = trainer.evaluate()
        out = dict(train=train, test=test, params=host(trainer.state.params))
        if trainer.cfg.optim.ema_decay > 0:
            out["ema"] = host(trainer.state.ema_params)
    finally:
        trainer.close()
    return out


def check_epoch(got_history, got_params, want, tag):
    """An epoch record and whole parameters against a reference's."""
    rec = got_history[0]
    assert abs(rec["train_loss"] - want["train"]["loss"]) < LOSS_TOL, tag
    assert abs(rec["test_accuracy"] - want["test"]["accuracy"]) < ACC_TOL, tag
    check_params(got_params, want["params"], tag)


def check_params(got_params, want_params, tag):
    """Whole parameters (or their EMA) against a reference's."""
    for k, w in want_params.items():
        got, w = got_params[k].numpy(), np.asarray(w)
        if k.endswith("attn.qkv.bias"):
            # The key bias's exact gradient is 0 (softmax is invariant to
            # a per-query shift), and Adam's lr * g / (|g| + eps) turns
            # its rounding noise into full steps either way: q and v only.
            got, w = got.reshape(3, -1)[[0, 2]], w.reshape(3, -1)[[0, 2]]
        np.testing.assert_allclose(got, w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{tag} {k}")


def check_ranks(dumps, whole, table, mesh):
    """The ranks' parameters: each replicated leaf equal to the bit on
    every rank, its gradient equal to the bit on the ranks of a 'model'
    group before they are averaged (a gap of 0 to their mean at every
    step), and the pieces of a 'model'-split leaf joined (over the ranks
    of one data index) equal to the whole parameters rank 0 saved."""
    m = mesh["model"]
    replicated = {k for k, lay in table.items()
                  if lay.param is None or lay.param.axis != "model"}
    for dump in dumps:
        assert set(dump["replicated_gaps"]) == replicated
        assert all(v == 0.0 for v in dump["replicated_gaps"].values()), \
            {k: v for k, v in dump["replicated_gaps"].items() if v}
    for k, lay in table.items():
        if lay.param is None or lay.param.axis != "model":
            for r in range(1, len(dumps)):
                assert torch.equal(dumps[r]["params"][k],
                                   dumps[0]["params"][k]), (k, r)
            assert torch.equal(dumps[0]["params"][k], whole[k]), k
            continue
        for base in range(0, len(dumps), m):
            stacked = torch.stack([dumps[base + i]["params"][k]
                                   for i in range(m)])
            assert torch.equal(join(stacked, lay.param), whole[k]), k


# ------------------------------------------------------------- the rules

def _shapes(name, **kw):
    model = create_model(ModelConfig(**dict(VIT if name == "vit" else LM,
                                            **kw)), device="cpu",
                         image_size=SIZE)
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def test_rules_registry():
    assert rules_for(ModelConfig(**VIT)) == VIT_TP_RULES
    assert rules_for(ModelConfig(name="vit_tiny")) == VIT_TP_RULES
    assert rules_for(ModelConfig(**LM)) == VIT_TP_RULES
    assert rules_for(ModelConfig(name="mobilenet_v2")) == ()
    # The same four projections as tpunet's dense rules, weight and bias,
    # and its four expert leaves in one rule.
    jax_dense = [rx for rx, _ in JAX_VIT_TP_RULES if "moe" not in rx]
    jax_moe = [rx for rx, _ in JAX_VIT_TP_RULES if "moe" in rx]
    port_moe = [rx for rx, _ in VIT_TP_RULES if "moe" in rx]
    assert len(jax_dense) == 6 and len(VIT_TP_RULES) - len(port_moe) == 4
    assert len(jax_moe) == 4 and len(port_moe) == 1
    # Pruned on a mesh without a 'model' axis.
    assert rules_for(ModelConfig(**VIT), {"data": 4, "model": 1}) == ()


def test_table_follows_the_rules():
    table = layout(_shapes("vit"), ModelConfig(**VIT),
                   {"data": 4, "seq": 1, "pipe": 1, "model": 2})
    b = "blocks.0."
    assert table[b + "attn.qkv.weight"].param == Shard(0, "model", 3)
    assert table[b + "attn.qkv.bias"].param == Shard(0, "model", 3)
    assert table[b + "attn.out.weight"].param == Shard(1, "model")
    assert table[b + "attn.out.bias"].param is None
    assert table[b + "mlp.fc1.weight"].param == Shard(0, "model")
    assert table[b + "mlp.fc2.weight"].param == Shard(1, "model")
    assert table["pos_embed"].param is None
    assert table[b + "ln1.weight"].param is None
    # Adam moments mirror their parameters.
    for lay in table.values():
        assert lay.moments == lay.param


def test_indivisible_rule_falls_back_to_replicated():
    rules = [(r"qkv\.weight$", Shard(1, "model"))]
    mesh = {"data": 4, "model": 2}
    assert _spec_for("params/attn.qkv.weight", (4, 7), mesh, rules) is None
    assert _spec_for("params/attn.qkv.weight", (4, 8), mesh, rules) == \
        Shard(1, "model")


def test_zero1_composes_with_tp():
    """With model > 1 the TP rules win for matched moments; ZeRO-1 takes
    the rest (dim 0 over 'data'), and the parameters stay as they were."""
    cfg = ModelConfig(**VIT)
    mesh = {"data": 2, "seq": 1, "pipe": 1, "model": 2}
    table = layout(_shapes("vit"), cfg, mesh, zero1=True)
    assert table["blocks.0.attn.qkv.weight"].moments == Shard(0, "model", 3)
    assert table["blocks.0.ln1.weight"].moments == Shard(0, "data")
    assert table["blocks.0.ln1.weight"].param is None
    # pos_embed [1, tokens, C]: dim 0 of 1 is indivisible -> replicated.
    assert table["pos_embed"].moments is None
    assert rules_for(cfg, mesh, zero1=True) == VIT_TP_RULES + ZERO1_RULES


def test_qkv_split_gives_whole_heads_of_tpunet_kernel():
    """Rank r's piece of the port's qkv weight [3C, C] (tpunet's kernel
    [C, 3C] transposed) holds rows (q, k, v) x its heads, and the pieces
    joined are tpunet's kernel exactly."""
    _, params = jax_vit_params()
    kernel = params["block00"]["attn"]["qkv"]["kernel"]       # [C, 3C]
    sd = vit_state_dict_from_jax(params)
    w = sd["blocks.0.attn.qkv.weight"]
    c, heads = VIT["vit_hidden"], VIT["vit_heads"]
    hd, n = c // heads, WORLD
    spec = Shard(0, "model", 3)
    got = pieces(w, spec, n)
    per = kernel.reshape(c, 3, heads, hd)
    for r in range(n):
        want = per[:, :, r * heads // n:(r + 1) * heads // n].reshape(c, -1)
        np.testing.assert_array_equal(got[r].numpy(), want.T)
    np.testing.assert_array_equal(join(got, spec).numpy(), kernel.T)
    bias = sd["blocks.0.attn.qkv.bias"]
    assert torch.equal(join(pieces(bias, spec, n), spec), bias)


def test_cli_parses_tpunet_mesh_flags_and_refuses_seq_pipe():
    """The mesh flags map as tpunet's do. --mesh-seq and --mesh-pipe,
    refused until sequence and pipeline parallelism were ported (ROADMAP
    Queue A items 8b and 8d), now give tpunet's mesh."""
    from tpunet.config import config_from_args as jax_config_from_args
    cfg, _ = cli.config_from_args(["--model", "lm", "--dataset",
                                   "synthetic_lm", "--mesh-data", "2",
                                   "--mesh-model", "2", "--zero1",
                                   "--vocab-ce", "sharded"])
    assert (cfg.mesh.data, cfg.mesh.model, cfg.mesh.zero1) == (2, 2, True)
    assert cfg.mesh.shape(4) == (2, 1, 1, 2)
    pipe = ["--model", "lm_pp", "--dataset", "synthetic_lm", "--mesh-pipe",
            "2"]
    cfg, _ = cli.config_from_args(pipe)
    assert cfg.mesh.pipe == jax_config_from_args(pipe).mesh.pipe == 2
    argv = ["--model", "lm", "--dataset", "synthetic_lm", "--mesh-seq", "2",
            "--mesh-model", "2", "--attention", "ring"]
    cfg, _ = cli.config_from_args(argv)
    want = jax_config_from_args(argv).mesh
    assert (cfg.mesh.data, cfg.mesh.seq, cfg.mesh.pipe, cfg.mesh.model) == (
        want.data, want.seq, want.pipe, want.model)
    assert cfg.mesh.shape(8) == (2, 2, 1, 2)


# ------------------------------------------------------------ two ranks

@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The 2-rank gang started, tpunet's references computed while it
    runs; then every rank's results."""
    d = tmp_path_factory.mktemp("tp")
    jvit, params = jax_vit_params()
    torch.save(vit_state_dict_from_jax(params), d / "vit.pt")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, SIZE, SIZE, 3)).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int64)
    np.savez(d / "images.npz", x=x, y=y)
    jax_trainer = jax_lm_start(2, d)
    (d / "flags.json").write_text(json.dumps({
        "lm": LM_FLAGS + ["--mesh-model", "2", "--batch-size", "8",
                          "--pretrained", str(d / "lm.pth")],
        "vit": VIT_FLAGS + ["--preset", "distributed", "--mesh-model", "2",
                            "--batch-size", "16"],
        "lm_drop": LM_FLAGS + ["--mesh-model", "2", "--batch-size", "8",
                               "--dropout-rate", "0.2"]}))
    procs = _torch_gang.start(d, WORLD, ["vit_grad", "lm", "vit", "lm_drop"])
    lm_ref = jax_lm_epoch(jax_trainer)

    def loss_fn(p):
        logits = jvit.apply({"params": p}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32)).mean(), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    vit_ref = dict(loss=float(jloss), logits=np.asarray(jlogits),
                   grads=vit_state_dict_from_jax(jax.tree_util.tree_map(
                       np.asarray, jgrads)))
    one = cli.run(VIT_FLAGS + ["--preset", "single", "--batch-size", "16",
                               "--checkpoint-dir", str(d / "vit_w1")])
    vit_epoch_ref = dict(
        train={"loss": one.history[0]["train_loss"]},
        test={"accuracy": one.history[0]["test_accuracy"]},
        params={k: v.numpy() for k, v in torch.load(
            d / "vit_w1" / "state.pt")["model"].items()})
    assert LM_FLAGS[:2] == ["--preset", "distributed"]
    drop = cli.run(["--preset", "single"] + LM_FLAGS[2:] + [
        "--batch-size", "8", "--dropout-rate", "0.2", "--checkpoint-dir",
        str(d / "lm_drop_w1")])
    _torch_gang.wait(d, WORLD, procs)
    load = lambda case: [torch.load(d / f"{case}_rank{r}.pt")  # noqa: E731
                         for r in range(WORLD)]
    return dict(d=d, vit_ref=vit_ref, lm_ref=lm_ref,
                vit_epoch_ref=vit_epoch_ref, vit_grad=load("vit_grad"),
                lm=load("lm"), vit=load("vit"), lm_drop=load("lm_drop"),
                lm_drop_ref=drop.history[0])


def test_tp_vit_forward_backward_matches_tpunet(gang):
    ref = gang["vit_ref"]
    gmax = max(float(np.abs(g).max()) for g in ref["grads"].values())
    assert gmax > 1e-2
    for got in gang["vit_grad"]:
        assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   rtol=1e-5, atol=1e-5)
        assert set(got["grads"]) == set(ref["grads"])
        for k, g in got["grads"].items():
            err = float((g - torch.as_tensor(ref["grads"][k])).abs().max())
            assert err <= 1e-5 * gmax, (k, err, gmax)


@pytest.mark.parametrize("name", ["lm", "vit"])
def test_tp_epoch_matches_its_reference(gang, name):
    """The epoch at 'model' 2 against tpunet's (the LM) or the port's
    one-process epoch (the ViT), and the ranks' parameters."""
    d, dumps = gang["d"], gang[name]
    whole = torch.load(d / f"ck_{name}" / "state.pt")["model"]
    ref = gang["lm_ref"] if name == "lm" else gang["vit_epoch_ref"]
    for dump in dumps:
        check_epoch(dump["history"], whole, ref, name)
    cfg = ModelConfig(**(LM if name == "lm" else VIT))
    table = layout(_shapes(name), cfg, MESH)
    check_ranks(dumps, whole, table, MESH)


def test_tp_at_dropout_keeps_one_ranks_masks(gang):
    """Every mask lies on a replicated activation and is seeded from the
    data index, so at dropout 0.2 the 'model' ranks draw one rank's
    masks: the epoch equals the one-process epoch (the LM from its own
    seeded init)."""
    want = gang["lm_drop_ref"]
    for dump in gang["lm_drop"]:
        got = dump["history"][0]
        assert abs(got["train_loss"] - want["train_loss"]) < LOSS_TOL
        assert abs(got["test_accuracy"] - want["test_accuracy"]) < ACC_TOL
