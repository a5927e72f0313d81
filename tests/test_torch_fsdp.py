"""FSDP and ZeRO-1 of the port (the state split over the mesh's 'data'
axis) against tpunet, on the CPU.

- The rule table mirrors tests/test_fsdp.py:73-133: ``_fsdp_spec`` picks
  the largest divisible dim (none: replicated), FSDP's rules come after
  the model's and subsume ZeRO-1's, a TP rule that cannot split a leaf
  falls through to the FSDP catch-all, and a TP-matched leaf keeps its
  'model' split while FSDP takes the rest.
- On 4 gloo ranks (``tests/_torch_shard_worker.py``), ``python -m
  tpunet_torch.train --preset distributed --mesh-model 2 --fsdp`` (data
  2 x model 2) for one epoch, both with ``--ema-decay`` and
  ``--clip-norm``: the LM from tpunet's initial weights against
  tpunet's Trainer on its CPU mesh at data 2 with the same options, and
  the ViT against the port's one-process epoch, at
  tests/test_tp.py:84-86's loss and accuracy bounds and
  tests/test_fsdp.py:150-153's parameter bounds, for the parameters and
  their EMA; the replicated leaves equal to the bit on every rank; what
  a rank keeps of an FSDP leaf is half of it (the parameter and both
  moments). Then MobileNetV2 (the plain versions of kernels 1-4) at
  data 4 with ``--fsdp`` and with ``--zero1`` against the same run
  without: the epoch's numbers to 1e-4 relative (tests/test_torch_dp.py's
  bound), the parameters at the same bounds as above and the Adam
  moments (joined from the pieces) within 2e-4 relative plus 5e-3 of
  the leaf's largest, and a quarter of each split leaf's moments a rank.
  Left out of both are the leaves whose gradient in the reference run
  is 0 to rounding (:func:`zero_gradient_leaves`, a rule on the
  reference's second moments); Adam turns that rounding noise into
  steps of the learning rate in either run. The rule picks exactly the
  beta of each block's projection BN (:func:`projection_bn_biases`): a
  linear bottleneck whose output reaches the loss only through 1x1
  convolutions into train-mode BN, which removes a per-channel shift.
- tests/test_fsdp.py:208's re-mesh restore: the whole state the FSDP
  runs saved (rank 0, gathered) is the ranks' pieces joined, to the bit
  (every moment of every leaf); ``--resume`` of it at world 1 holds that
  state to the bit, and its next epoch is bit-equal to the next epoch of
  a world-1 run resumed from the same state saved by one process.
"""

import json
import math
import re
import shutil

import pytest
import torch

from tpunet_torch.config import ModelConfig
from tpunet_torch.parallel.tp import (FSDP, FSDP_RULES, VIT_TP_RULES, Shard,
                                      _fsdp_spec, _spec_for, join, layout,
                                      rules_for)
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer

import _torch_gang
import _torch_threads  # noqa: F401
from test_torch_tp import (LM, LM_FLAGS, PARAM_ATOL, PARAM_RTOL, VIT,
                           VIT_FLAGS, _shapes, check_epoch, check_params,
                           check_ranks, jax_lm_epoch, jax_lm_start)

WORLD = 4
MESH = {"data": 2, "seq": 1, "pipe": 1, "model": 2}
EMA_DECAY, CLIP_NORM = 0.9, 0.5
OPTS = ["--ema-decay", str(EMA_DECAY), "--clip-norm", str(CLIP_NORM)]
MNV2_FLAGS = ["--preset", "distributed", "--device", "cpu", "--dataset",
              "synthetic", "--synthetic-size", "32", "--image-size", "32",
              "--width-mult", "0.5", "--dtype", "float32", "--batch-size", "4",
              "--epochs", "1", "--no-obs", "--pallas-depthwise", "--seed", "1",
              "--no-native-loader"]
EPOCH_RTOL = 1e-4
# The Adam moments of a split run against data parallelism's: the stem
# BN's scale reads 1.2e-3 of its largest (train-mode BN at random init
# amplifies the last bits by which the pieces' reduce-scatter and the
# all-reduce sum in another order), every other leaf under 5e-5.
MOMENT_RTOL, MOMENT_ATOL_FRAC = 2e-4, 5e-3
# A gradient is 0 to rounding when its root mean square over the steps
# (the root of Adam's second moment) stays under this fraction of the
# model's largest: 2e-10 to 1.1e-7 for the projection betas here, 5.5e-5
# for the smallest other leaf (at MobileNetV2 1.0, 224 px, batch 128 on
# an H100: up to 2.5e-6, and 2.2e-5).
ZERO_GRAD_RATIO = 7e-6


def zero_gradient_leaves(moments):
    """The parameters whose gradient is 0 to rounding in the run whose
    whole Adam moments are ``moments`` (name -> {"exp_avg_sq": ...})."""
    rms = {k: math.sqrt(float(st["exp_avg_sq"].max()))
           for k, st in moments.items()}
    top = max(rms.values())
    return {k for k, v in rms.items() if v < ZERO_GRAD_RATIO * top}


def projection_bn_biases(names):
    """The beta of the BN after each inverted-residual block's linear
    projection, the last module of its ``conv`` sequence."""
    last = {}
    for k in names:
        m = re.match(r"features\.(\d+)\.conv\.(\d+)\.", k)
        if m:
            last[m[1]] = max(last.get(m[1], 0), int(m[2]))
    return {f"features.{b}.conv.{j}.bias" for b, j in last.items()}


def _ema_by_name(saved, names):
    """The saved whole EMA list (parameters first) by parameter name."""
    return dict(zip(names, saved["ema"]))


# ------------------------------------------------------------- the rules

def test_fsdp_spec_picks_largest_divisible_dim():
    assert _fsdp_spec((64, 192), 8) == Shard(1, "data")
    assert _fsdp_spec((192, 64), 8) == Shard(0, "data")
    assert _fsdp_spec((1, 65, 64), 8) == Shard(2, "data")
    assert _fsdp_spec((7, 3), 8) is None
    assert _fsdp_spec((), 8) is None
    assert _fsdp_spec((64,), 1) is None


def test_fsdp_rules_appended_and_subsume_zero1():
    assert rules_for(ModelConfig(name="mobilenet_v2"), fsdp=True) == FSDP_RULES
    assert rules_for(ModelConfig(name="mobilenet_v2"), zero1=True,
                     fsdp=True) == FSDP_RULES
    assert _spec_for("params/dense.weight", (192, 64), {"data": 8},
                     [(r"^params/", FSDP)]) == Shard(0, "data")


def test_unfit_rule_falls_through_to_fsdp():
    rules = [(r"qkv\.weight$", Shard(0, "model", 3)), (r"^params/", FSDP)]
    mesh = {"data": 4, "model": 2}
    # 3 x 5 rows do not split into 2 x 3 blocks: FSDP's largest dim.
    assert _spec_for("params/attn.qkv.weight", (15, 64), mesh, rules) == \
        Shard(1, "data")
    assert _spec_for("params/attn.qkv.weight", (15, 64), mesh,
                     rules[:1]) is None


def test_tp_wins_over_fsdp_and_fsdp_takes_the_rest():
    table = layout(_shapes("vit"), ModelConfig(**VIT), MESH, fsdp=True)
    assert table["blocks.0.attn.qkv.weight"].param == Shard(0, "model", 3)
    assert table["blocks.0.mlp.fc1.weight"].param == Shard(0, "model")
    assert table["blocks.0.ln1.weight"].param == Shard(0, "data")
    # The port's [out, in] patch kernel [64, 3, 4, 4]: its largest dim.
    assert table["patch_embed.weight"].param == Shard(0, "data")
    for lay in table.values():
        assert lay.moments == lay.param
    assert rules_for(ModelConfig(**VIT), MESH, fsdp=True) == \
        VIT_TP_RULES + FSDP_RULES


def test_mobilenet_fsdp_splits_a_channel_dim():
    shapes = {"features.1.conv.0.0.weight": (16, 1, 3, 3),
              "features.0.0.weight": (16, 3, 3, 3)}
    table = layout(shapes, ModelConfig(name="mobilenet_v2"),
                   {"data": 4, "seq": 1, "pipe": 1, "model": 1}, fsdp=True)
    assert table["features.1.conv.0.0.weight"].param == Shard(0, "data")
    zero = layout(shapes, ModelConfig(name="mobilenet_v2"),
                  {"data": 4, "seq": 1, "pipe": 1, "model": 1}, zero1=True)
    assert zero["features.0.0.weight"] == (None, Shard(0, "data"))


# ------------------------------------------------------------ four ranks

@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    jax_trainer = jax_lm_start(2, d, ema_decay=EMA_DECAY, clip_norm=CLIP_NORM)
    mesh = ["--mesh-model", "2", "--fsdp"]
    (d / "flags.json").write_text(json.dumps({
        "lm": LM_FLAGS + OPTS + mesh + ["--batch-size", "4", "--pretrained",
                                        str(d / "lm.pth")],
        "vit": VIT_FLAGS + OPTS + ["--preset", "distributed",
                                   "--batch-size", "8"] + mesh,
        "mnv2": MNV2_FLAGS, "mnv2_fsdp": MNV2_FLAGS + ["--fsdp"],
        "mnv2_zero1": MNV2_FLAGS + ["--zero1"]}))
    cases = ["lm", "vit", "mnv2", "mnv2_fsdp", "mnv2_zero1"]
    procs = _torch_gang.start(d, WORLD, cases)
    lm_ref = jax_lm_epoch(jax_trainer)
    one = cli.run(VIT_FLAGS + OPTS + [
        "--preset", "single", "--batch-size", "16", "--checkpoint-dir",
        str(d / "vit_w1")])
    saved = torch.load(d / "vit_w1" / "state.pt")
    vit_ref = dict(
        train={"loss": one.history[0]["train_loss"]},
        test={"accuracy": one.history[0]["test_accuracy"]},
        params={k: v.numpy() for k, v in saved["model"].items()},
        ema={k: v.numpy() for k, v in _ema_by_name(
            saved, _shapes("vit")).items()})
    _torch_gang.wait(d, WORLD, procs)
    out = {c: [torch.load(d / f"{c}_rank{r}.pt") for r in range(WORLD)]
           for c in cases}
    return dict(d=d, lm_ref=lm_ref, vit_ref=vit_ref, **out)


@pytest.mark.parametrize("name", ["lm", "vit"])
def test_fsdp_tp_epoch_matches_its_reference(gang, name):
    d, dumps = gang["d"], gang[name]
    saved = torch.load(d / f"ck_{name}" / "state.pt")
    whole = saved["model"]
    ref = gang["lm_ref" if name == "lm" else "vit_ref"]
    for dump in dumps:
        check_epoch(dump["history"], whole, ref, name)
    check_params(_ema_by_name(saved, _shapes(name)), ref["ema"], f"{name} ema")
    cfg = ModelConfig(**(LM if name == "lm" else VIT))
    table = layout(_shapes(name), cfg, MESH, fsdp=True)
    check_ranks(dumps, whole, table, MESH)
    # A rank keeps half of each FSDP leaf and none of it whole.
    for dump in dumps:
        res = dump["resident"]
        fsdp = res["fsdp"]
        assert fsdp and set(fsdp) == {k for k, lay in table.items()
                                      if lay.param is not None
                                      and lay.param.axis == "data"}
        assert 2 * res["masters"] == sum(whole[k].numel() for k in fsdp)
        tp_local = sum(whole[k].numel() // 2 for k, lay in table.items()
                       if lay.param is not None and lay.param.axis == "model")
        assert res["params"] == tp_local


def _joined_moments(dumps, mesh):
    """The whole moments of every parameter, joined from the ranks'
    pieces as their splits say (the ranks of one 'model' index for a
    'data' split, of one 'data' index for a 'model' split)."""
    m, n = mesh["model"], len(dumps)
    out = {}
    for name, spec in dumps[0]["moment_specs"].items():
        out[name] = {}
        for key, v in dumps[0]["moments"][name].items():
            if spec is None or v.dim() == 0:
                for dump in dumps[1:]:
                    assert torch.equal(dump["moments"][name][key], v), name
                out[name][key] = v
                continue
            spec = Shard(*spec)
            ranks = (range(0, n, m) if spec.axis == "data"
                     else range(m))
            out[name][key] = join(torch.stack(
                [dumps[r]["moments"][name][key] for r in ranks]), spec)
    return out


@pytest.mark.parametrize("name", ["lm", "vit"])
def test_saved_state_is_the_pieces_joined_and_resumes_at_world_one(
        gang, name, tmp_path):
    d = gang["d"]
    saved = torch.load(d / f"ck_{name}" / "state.pt")
    names = list(saved["model"])
    joined = _joined_moments(gang[name], MESH)
    params = [k for k in names if k in joined]
    for i, k in enumerate(params):
        for key, v in joined[k].items():
            assert torch.equal(saved["optimizer"]["state"][i][key], v), (k, key)
    flags = OPTS + (LM_FLAGS + ["--pretrained", str(d / "lm.pth")]
                    if name == "lm" else VIT_FLAGS)
    flags = ["single" if f == "distributed" else f for f in flags]
    if "--preset" not in flags:
        flags = ["--preset", "single"] + flags
    batch = "8" if name == "lm" else "16"

    def resumed(ck):
        cfg, _ = cli.config_from_args(flags + [
            "--batch-size", batch, "--epochs", "2", "--resume",
            "--checkpoint-dir", str(ck)])
        return Trainer(cfg, device="cpu")

    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    shutil.copytree(d / f"ck_{name}", a_dir)
    a = resumed(a_dir)
    try:
        assert a.start_epoch == 2 and a.global_step == saved["global_step"]
        for k, v in a.state.model.state_dict().items():
            assert torch.equal(v, saved["model"][k]), k
        for i, st in a.state.optimizer.state_dict()["state"].items():
            for key, v in st.items():
                assert torch.equal(v, saved["optimizer"]["state"][i][key])
        for e, s in zip(a.state.ema, saved["ema"], strict=True):
            assert torch.equal(e, s)
        # The same state saved by one process: the next epochs agree.
        a.ckpt.directory = str(b_dir)
        a.ckpt.save_state(a._payload(1))
        a.train()
    finally:
        a.close()
    b = resumed(b_dir)
    try:
        b.train()
        for (k, v), w in zip(a.state.model.state_dict().items(),
                             b.state.model.state_dict().values()):
            assert torch.equal(v, w), k
    finally:
        b.close()


def test_mobilenet_fsdp_and_zero1_match_data_parallel(gang):
    ref = gang["mnv2"][0]
    base, moments = ref["history"][0], ref["moments"]
    zero = zero_gradient_leaves(moments)
    assert zero == projection_bn_biases(moments), sorted(zero)
    for name in ("mnv2_fsdp", "mnv2_zero1"):
        dumps = gang[name]
        for dump in dumps:
            rec = dump["history"][0]
            for key in ("train_loss", "test_loss"):
                assert abs(rec[key] - base[key]) <= EPOCH_RTOL * abs(base[key])
            for key in ("train_accuracy", "test_accuracy"):
                assert abs(rec[key] - base[key]) < 1e-6
            for k in moments:
                if k not in zero:
                    torch.testing.assert_close(
                        dump["params"][k], ref["params"][k], rtol=PARAM_RTOL,
                        atol=PARAM_ATOL, msg=lambda m: f"{name} {k}: {m}")
            res = dump["resident"]
            assert res["data_split"]
            if name == "mnv2_fsdp":
                assert res["fsdp"] == res["data_split"]
            else:
                assert res["fsdp"] == []
        joined = _joined_moments(dumps, {"data": WORLD, "model": 1})
        for k, st in moments.items():
            if k in zero:
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                want = st[key]
                torch.testing.assert_close(
                    joined[k][key], want, rtol=MOMENT_RTOL,
                    atol=MOMENT_ATOL_FRAC * float(want.abs().max()),
                    msg=lambda m: f"{name} {k} {key}: {m}")
