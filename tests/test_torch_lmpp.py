"""The pipelined LM of the port (``--model lm_pp``, ``--mesh-pipe``)
against tpunet, on the CPU.

- ``lm_pp`` at pipe 1 is the LM: its logits on tpunet's ``lm_pp``
  weights (stacked, through ``tpunet_torch.models.convert``) equal
  tpunet's ``PipelinedLM``'s within 1e-5 (dense and flash cores, MoE,
  packed segments).
- ``convert.py`` both ways: tpunet's stacked trees (MoE stacks, the
  interleaved chunk permutation) against ``to_transformer_lm_params``,
  and back to the stacks exactly.
- Every validation message of tpunet's ``lm_pp.create_model`` and of
  its Trainer's grad-accum x pipeline check, equal to tpunet's.
- Gloo gangs (``tests/_torch_shard_worker.py``, the CLI in each rank),
  one epoch of 2 steps a case in float32 at dropout 0, each against
  tpunet's Trainer on the same mesh (tests/test_torch_tp.py's bounds:
  train loss within 1e-4, test accuracy within 1e-6, parameters within
  rtol 2e-4 / atol 2e-5 but the qkv key bias), and in every case the
  leaves every stage holds equal to the bit on every rank and every
  rank's parameters equal to the whole state rank 0 saved:
  data 2 x pipe 2 under ``--zero1`` and ``--fsdp`` with ``--grad-accum 2
  --clip-norm`` (one reference: the sharding changes no value); pipe 2 x
  seq 2 under Ulysses and ring (1f1b); the MoE LM at pipe 2 x model 2,
  its experts over 'model' (EP x PP, 1f1b); and the MoE LM at
  ``--pp-microbatches 1`` against tpunet's unpipelined MoE LM, the aux
  term included (each stage routes the whole batch then).

The schedules' own trainer runs (gpipe, 1f1b, interleaved, packed) and
the generate/serve checks of an interleaved checkpoint are in
tests/test_torch_pp.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
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
from tpunet.models.lm_pp import to_transformer_lm_params
from tpunet.parallel import make_mesh as jax_make_mesh
from tpunet.train.loop import Trainer as JaxTrainer
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import (lm_params_to_jax,
                                         lm_state_dict_from_jax,
                                         load_state_dict)
from tpunet_torch.parallel import dist
from tpunet_torch.parallel.mesh import AXES, Mesh, set_mesh
from tpunet_torch.parallel.tp import Shard, piece

import _torch_gang
import _torch_threads  # noqa: F401
from test_torch_tp import check_epoch

LMPP = dict(name="lm_pp", vit_hidden=32, vit_depth=4, vit_heads=2,
            vocab_size=32, max_seq_len=32, dtype="float32",
            dropout_rate=0.0, attention="dense")
LMPP_DATA = dict(dataset="synthetic_lm", batch_size=8,
                 synthetic_train_size=16, synthetic_test_size=4, seq_len=32,
                 vocab_size=32)
LR = 1e-3
CLIP = 0.5
MOE = dict(moe_experts=4, moe_dispatch="replicated")
LMPP_FLAGS = ["--preset", "distributed", "--device", "cpu", "--model",
              "lm_pp", "--dataset", "synthetic_lm", "--vit-hidden", "32",
              "--vit-depth", "4", "--vit-heads", "2", "--vocab-size", "32",
              "--seq-len", "32", "--max-seq-len", "32", "--synthetic-size",
              "16", "--dtype", "float32", "--dropout-rate", "0", "--lr",
              str(LR), "--epochs", "1", "--no-obs", "--no-native-loader",
              "--attention", "dense"]


def jax_pp_trainer(d, tag, mesh, model=None, data=None, optim=None,
                   layout=None) -> dict:
    """tpunet's Trainer of ``tag`` (``LMPP`` with ``model``'s fields) on
    ``mesh``, its initial weights written to ``d/<tag>.pth`` in the
    port's plain layer order (``layout``: the interleaved run's pipe and
    virtual) for the port's ``--pretrained``."""
    trainer = JaxTrainer(JaxTrainConfig(
        epochs=1, data=JaxDataConfig(**dict(LMPP_DATA, **(data or {}))),
        model=JaxModelConfig(**dict(LMPP, **(model or {}))),
        optim=JaxOptimConfig(learning_rate=LR, **(optim or {})),
        mesh=JaxMeshConfig(**mesh),
        checkpoint=JaxCheckpointConfig(save_best=False, save_last=False)))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(trainer.state.params))
    torch.save(lm_state_dict_from_jax(init, **(layout or {})),
               d / f"{tag}.pth")
    return dict(trainer=trainer, layout=layout or {})


def jax_pp_epoch(ref) -> dict:
    trainer = ref["trainer"]
    try:
        train = trainer.train_one_epoch(1)
        test = trainer.evaluate()
        params = jax.tree_util.tree_map(np.asarray,
                                        jax.device_get(trainer.state.params))
        return dict(train=train, test=test,
                    params=lm_state_dict_from_jax(params, **ref["layout"]),
                    stacked=params)
    finally:
        trainer.close()


def check_pp_ranks(d, name, dumps, model=1):
    """The leaves every stage holds equal to the bit on every rank, and
    every rank's parameters equal to the whole state rank 0 saved (its
    stage's blocks among them; an expert leaf split over a 'model' axis
    of ``model`` ranks, its piece); returns that state."""
    whole = torch.load(d / f"ck_{name}" / "state.pt")["model"]
    for r, dump in enumerate(dumps):
        for k, v in dump["params"].items():
            w = whole[k]
            if v.shape != w.shape:
                spec = Shard(*dump["moment_specs"][k])
                w = piece(w, spec, model, r % model)   # 'model' is last
            assert torch.equal(v, w), (name, k, r)
        for k, v in dumps[0]["params"].items():
            if not k.startswith("blocks."):
                assert torch.equal(dump["params"][k], v), (name, k, r)
    return whole


def run_gangs(d, flags, gangs, refs):
    """Write ``flags``, start ``gangs`` ({world: [cases of a gang, ...]}),
    run the references' epochs meanwhile, then wait; returns (the
    references' epochs, each case's rank dumps)."""
    (d / "flags.json").write_text(json.dumps(flags))
    started = [(world, _torch_gang.start(d, world, cases, tag=f"g{i}"))
               for i, (world, cases) in enumerate(gangs)]
    want = {name: jax_pp_epoch(ref) for name, ref in refs.items()}
    for world, gang in started:
        _torch_gang.wait(d, world, gang)
    got = {}
    for world, cases in gangs:
        for name in cases:
            got[name] = [torch.load(d / f"{name}_rank{r}.pt")
                         for r in range(world)]
    return want, got


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("lmpp")
    base = LMPP_FLAGS + ["--pp-schedule", "1f1b"]
    sharded = ["--mesh-data", "2", "--mesh-pipe", "2", "--batch-size", "4",
               "--pp-microbatches", "2", "--grad-accum", "2", "--clip-norm",
               str(CLIP), "--pretrained", str(d / "dp.pth")]
    flags = {
        "lmpp_zero1": base + sharded + ["--zero1"],
        "lmpp_fsdp": base + sharded + ["--fsdp"],
        "lmpp_ulysses": base + ["--mesh-seq", "2", "--mesh-pipe", "2",
                                "--attention", "ulysses", "--batch-size",
                                "8", "--pretrained", str(d / "ulysses.pth")],
        "lmpp_ring": base + ["--mesh-seq", "2", "--mesh-pipe", "2",
                             "--attention", "ring", "--batch-size", "8",
                             "--pretrained", str(d / "ring.pth")],
        "lmpp_ep": base + ["--mesh-pipe", "2", "--mesh-model", "2",
                           "--moe-experts", "4", "--moe-dispatch",
                           "replicated", "--batch-size", "8",
                           "--pretrained", str(d / "ep.pth")],
        "lmpp_moe_m1": base + ["--mesh-pipe", "2", "--moe-experts", "4",
                               "--pp-microbatches", "1", "--batch-size",
                               "8", "--pretrained", str(d / "moe_m1.pth")]}
    refs = {
        "lmpp_zero1": jax_pp_trainer(
            d, "dp", dict(data=2, pipe=2), dict(pp_schedule="1f1b",
                                                pp_microbatches=2),
            optim=dict(grad_accum=2, clip_norm=CLIP)),
        "lmpp_ulysses": jax_pp_trainer(
            d, "ulysses", dict(data=1, seq=2, pipe=2),
            dict(pp_schedule="1f1b", attention="ulysses")),
        "lmpp_ring": jax_pp_trainer(
            d, "ring", dict(data=1, seq=2, pipe=2),
            dict(pp_schedule="1f1b", attention="ring")),
        "lmpp_ep": jax_pp_trainer(
            d, "ep", dict(data=1, pipe=2, model=2),
            dict(pp_schedule="1f1b", **MOE)),
        "lmpp_moe_m1": jax_pp_trainer(
            d, "moe_m1", dict(data=1), dict(name="lm", moe_experts=4))}
    want, got = run_gangs(d, flags, [
        (4, ["lmpp_zero1", "lmpp_fsdp"]), (4, ["lmpp_ulysses", "lmpp_ring"]),
        (4, ["lmpp_ep"]), (2, ["lmpp_moe_m1"])], refs)
    want["lmpp_fsdp"] = want["lmpp_zero1"]
    return dict(d=d, want=want, got=got)


@pytest.mark.parametrize("name", ["lmpp_zero1", "lmpp_fsdp", "lmpp_ulysses",
                                  "lmpp_ring", "lmpp_ep", "lmpp_moe_m1"])
def test_lmpp_epoch_matches_tpunets_trainer(gang, name):
    dumps = gang["got"][name]
    whole = check_pp_ranks(gang["d"], name, dumps,
                           model=2 if name == "lmpp_ep" else 1)
    for dump in dumps:
        check_epoch(dump["history"], whole, gang["want"][name], name)


def test_lmpp_sharded_state_splits_the_stage(gang):
    """Under ZeRO-1 a stage's moments and under FSDP its parameters are
    split over its 'data' ranks; the blocks a rank holds are its stage's
    (pipe 2 of 4 layers: 2 each) and the 1f1b run kept min(S, M) graphs
    on stage 0."""
    for name in ("lmpp_zero1", "lmpp_fsdp"):
        for r, dump in enumerate(gang["got"][name]):
            res = dump["resident"]
            assert res["data_split"], name
            if name == "lmpp_fsdp":
                assert res["fsdp"] == res["data_split"]
            stage = r % 2            # row-major (data, seq, pipe, model)
            assert dump["pp"]["layers"] == [2 * stage, 2 * stage + 1]
            assert dump["pp"]["max_live"] == (2 if stage == 0 else 1)


def test_ep_keeps_the_experts_split_and_the_rest_whole(gang):
    for r, dump in enumerate(gang["got"]["lmpp_ep"]):
        wi = [k for k in dump["params"] if k.endswith("moe.wi")]
        assert wi and all(dump["params"][k].shape[0] == 2 for k in wi)
        assert dump["moment_specs"][wi[0]] == (0, "model", 1)
        assert dump["moment_specs"]["embed.weight"] is None
        assert all(v == 0.0 for v in dump["replicated_gaps"].values())


# ---------------------------------------------------------- pipe 1, convert

def _jax_lm_pp(seed=0, **kw):
    cfg = JaxModelConfig(**dict(LMPP, **kw))
    model = jax_create_model(cfg)
    v = init_variables(model, jax.random.PRNGKey(seed), seq_len=16)
    return model, jax.tree_util.tree_map(np.asarray, v["params"])


@pytest.mark.parametrize("attention,moe,packed", [
    ("dense", 0, False), ("flash", 0, False), ("dense", 4, False),
    ("dense", 0, True)], ids=["dense", "flash", "moe", "packed"])
def test_lm_pp_at_pipe_1_is_tpunets(attention, moe, packed):
    model, params = _jax_lm_pp(attention=attention, moe_experts=moe)
    port = create_model(ModelConfig(**dict(LMPP, attention=attention,
                                           moe_experts=moe)), device="cpu")
    assert type(port).__name__ == "PipelinedLM" and port.pp is None
    load_state_dict(port, lm_state_dict_from_jax(params))
    rng = np.random.default_rng(18)
    tokens = rng.integers(0, 32, (4, 32)).astype(np.int32)
    segs = (np.sort(rng.integers(1, 4, (4, 32)), axis=1).astype(np.int32)
            if packed else None)
    kw = {} if segs is None else {"segment_ids": jnp.asarray(segs)}
    want = model.apply({"params": params}, jnp.asarray(tokens), **kw)
    got = port(torch.from_numpy(tokens), segment_ids=None if segs is None
               else torch.from_numpy(segs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("moe", [0, 4])
@pytest.mark.parametrize("layout", [{}, {"pipe": 2, "virtual": 2}],
                         ids=["plain", "interleaved"])
def test_convert_stacked_trees_both_ways(moe, layout):
    _, params = _jax_lm_pp(vit_depth=8, moe_experts=moe)
    got = lm_state_dict_from_jax(params, **layout)
    want = lm_state_dict_from_jax(to_transformer_lm_params(params, **layout))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    back = lm_params_to_jax(got, stacked=True, **layout)
    assert back.keys() == params.keys()
    for k, v in params.items():
        if k.startswith("blocks_"):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    with pytest.raises(ValueError, match="together"):
        lm_state_dict_from_jax(params, pipe=2)


# ---------------------------------------------------------- validations

def _fake_mesh(**shape):
    shape = {a: shape.get(a, 1) for a in AXES}
    set_mesh(Mesh(shape, {a: 0 for a in AXES},
                  {a: dist.SELF for a in AXES}))


VALIDATIONS = [
    ("interleaved_pipe1", dict(pp_schedule="interleaved"), dict(pipe=1)),
    ("virtual1", dict(pp_schedule="interleaved", pp_virtual=1),
     dict(pipe=2)),
    ("chunks", dict(pp_schedule="interleaved", vit_depth=6), dict(pipe=2)),
    ("micro", dict(pp_schedule="interleaved", pp_microbatches=3),
     dict(pipe=2)),
    ("ileave_sp", dict(pp_schedule="interleaved", attention="ring"),
     dict(pipe=2)),
    ("ileave_moe", dict(pp_schedule="interleaved", vit_depth=8,
                        moe_experts=4, moe_every=4), dict(pipe=2)),
    ("moe_every", dict(moe_experts=4, vit_depth=3), dict(pipe=1)),
    ("super_layers", dict(moe_experts=4, vit_depth=6), dict(pipe=2)),
    ("experts", dict(moe_experts=3), dict(pipe=2, model=2)),
    ("remat", dict(remat=True), dict(pipe=2)),
    ("attention", dict(attention="blockwise"), dict(pipe=2)),
    ("ulysses_heads", dict(attention="ulysses", vit_heads=2,
                           vit_hidden=48, pp_schedule="gpipe"),
     dict(seq=4, pipe=1)),
    ("depth", dict(vit_depth=5), dict(pipe=2))]


@pytest.mark.parametrize("fields,mesh", [v[1:] for v in VALIDATIONS],
                         ids=[v[0] for v in VALIDATIONS])
def test_lm_pp_validation_messages_are_tpunets(fields, mesh):
    cfg = dict(LMPP, **fields)
    with pytest.raises(ValueError) as want:
        jax_create_model(JaxModelConfig(**cfg),
                         mesh=jax_make_mesh(JaxMeshConfig(data=1, **mesh)))
    _fake_mesh(**mesh)
    try:
        with pytest.raises(ValueError) as got:
            create_model(ModelConfig(**cfg), device="cpu")
    finally:
        set_mesh(None)
    assert str(got.value) == str(want.value)


def test_grad_accum_pipeline_message_is_tpunets(tmp_path):
    from tpunet_torch.config import (CheckpointConfig, DataConfig,
                                     MeshConfig, OptimConfig, TrainConfig)
    from tpunet_torch.train.loop import Trainer
    with pytest.raises(ValueError, match="grad_accum x pipeline") as want:
        JaxTrainer(JaxTrainConfig(
            epochs=1, data=JaxDataConfig(**LMPP_DATA),
            model=JaxModelConfig(**LMPP),
            optim=JaxOptimConfig(grad_accum=4),
            mesh=JaxMeshConfig(data=1, pipe=2),
            checkpoint=JaxCheckpointConfig(save_best=False,
                                           save_last=False)))
    _fake_mesh(pipe=2)
    import tpunet_torch.train.loop as loop
    real = loop.make_mesh
    loop.make_mesh = lambda cfg: loop.set_mesh(None) or _fake_mesh(pipe=2)
    try:
        with pytest.raises(ValueError) as got:
            Trainer(TrainConfig(
                epochs=1, data=DataConfig(**LMPP_DATA),
                model=ModelConfig(**LMPP), optim=OptimConfig(grad_accum=4),
                mesh=MeshConfig(data=1, pipe=2),
                checkpoint=CheckpointConfig(directory=str(tmp_path))),
                device="cpu")
    finally:
        loop.make_mesh = real
        set_mesh(None)
    assert str(got.value) == str(want.value)


def test_pipeline_flags_parse_to_tpunets_config():
    from tpunet.config import config_from_args as jax_config_from_args
    from tpunet_torch.train import __main__ as cli
    argv = ["--model", "lm_pp", "--dataset", "synthetic_lm", "--mesh-pipe",
            "2", "--mesh-seq", "2", "--pp-schedule", "interleaved",
            "--pp-virtual", "3", "--pp-microbatches", "6", "--attention",
            "ulysses"]
    cfg, _ = cli.config_from_args(argv)
    want = jax_config_from_args(argv)
    for f in dataclasses.fields(cfg.mesh):
        assert getattr(cfg.mesh, f.name) == getattr(want.mesh, f.name)
    for f in ("name", "pp_schedule", "pp_virtual", "pp_microbatches",
              "attention"):
        assert getattr(cfg.model, f) == getattr(want.model, f), f
