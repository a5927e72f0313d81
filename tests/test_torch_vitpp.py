"""The pipelined ViT of the port (``--model vit_pp``) against tpunet and
against the port's ViT, on the CPU.

- ``vit_pp`` at pipe 1 is the ViT: its logits on tpunet's ``vit_pp``
  weights (stacked, through ``tpunet_torch.models.convert``) equal
  tpunet's ``PipelinedViT``'s within 1e-5 (dense and flash cores), and at
  the same seed it draws the ``vit`` model's weights.
- ``convert.py`` both ways on tpunet's stacked ViT tree, the interleaved
  chunk permutation included.
- Every validation message of tpunet's ``vit_pp.create_model``, equal to
  tpunet's.
- ``python -m tpunet_torch.train --model vit_pp --mesh-pipe 2`` under each
  schedule (interleaved at v 2) on 2 gloo ranks, one epoch in float32 at
  dropout 0, against the port's one-process ``--model vit`` epoch of the
  same flags (the augmentation draws from torch's generator, not JAX's,
  so the reference is the port's, as tests/test_torch_tp.py's ViT's is):
  train loss within 1e-4, test accuracy within 1e-6, parameters within
  rtol 2e-4 / atol 2e-5 but the qkv key bias; the leaves every stage
  holds equal to the bit on both ranks. At dropout 0.1 (1f1b) the run's
  loss is finite and its replicated leaves stay equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.config import MeshConfig as JaxMeshConfig
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables
from tpunet.parallel import make_mesh as jax_make_mesh
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import (load_state_dict, unstack_blocks,
                                         vit_params_to_jax,
                                         vit_state_dict_from_jax)
from tpunet_torch.parallel.mesh import set_mesh
from tpunet_torch.train import __main__ as cli

import _torch_threads  # noqa: F401
from test_torch_lmpp import _fake_mesh, check_pp_ranks, run_gangs
from test_torch_tp import check_epoch

SIZE = 32
VITPP = dict(name="vit_pp", vit_patch=4, vit_hidden=32, vit_depth=4,
             vit_heads=2, dtype="float32", dropout_rate=0.0,
             attention="dense")
VIT_FLAGS = ["--device", "cpu", "--vit-patch", "4", "--vit-hidden", "32",
             "--vit-depth", "4", "--vit-heads", "2", "--dataset",
             "synthetic", "--synthetic-size", "32", "--image-size",
             str(SIZE), "--dtype", "float32", "--lr", "1e-3", "--epochs",
             "1", "--no-obs", "--no-native-loader", "--attention", "dense",
             "--batch-size", "16"]


def _jax_vit_pp(**kw):
    model = jax_create_model(JaxModelConfig(**dict(VITPP, **kw)))
    v = init_variables(model, jax.random.PRNGKey(3), image_size=SIZE)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    # Flax's zero head would hide the blocks: draw it from numpy.
    rng = np.random.default_rng(18)
    params["classifier"]["kernel"] = rng.normal(
        0, 0.5, params["classifier"]["kernel"].shape).astype(np.float32)
    return model, params


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_vit_pp_at_pipe_1_is_tpunets(attention):
    model, params = _jax_vit_pp(attention=attention)
    port = create_model(ModelConfig(**dict(VITPP, attention=attention)),
                        device="cpu", image_size=SIZE)
    assert type(port).__name__ == "PipelinedViT" and port.pp is None
    load_state_dict(port, vit_state_dict_from_jax(params))
    x = np.random.default_rng(18).normal(0, 1, (4, SIZE, SIZE, 3)).astype(
        np.float32)
    want = model.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_vit_pp_draws_the_vit_weights():
    cfg = dict(VITPP, dropout_rate=0.1)
    pp = create_model(ModelConfig(**cfg), device="cpu", image_size=SIZE,
                      generator=torch.Generator().manual_seed(7))
    vit = create_model(ModelConfig(**dict(cfg, name="vit")), device="cpu",
                       image_size=SIZE,
                       generator=torch.Generator().manual_seed(7))
    assert pp.state_dict().keys() == vit.state_dict().keys()
    for k, v in vit.state_dict().items():
        assert torch.equal(pp.state_dict()[k], v), k


@pytest.mark.parametrize("layout", [{}, {"pipe": 2, "virtual": 2}],
                         ids=["plain", "interleaved"])
def test_vit_convert_stacked_trees_both_ways(layout):
    _, params = _jax_vit_pp()
    got = vit_state_dict_from_jax(params, **layout)
    want = vit_state_dict_from_jax(unstack_blocks(params, **layout))
    assert got.keys() == want.keys()
    back = vit_params_to_jax(got, stacked=True, **layout)
    assert back.keys() == params.keys()
    for k, v in params.items():
        if k.startswith("blocks_"):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    np.testing.assert_array_equal(back["patch_embed"]["kernel"],
                                  params["patch_embed"]["kernel"])
    if layout:
        # The permutation: storage slot 1 of a 4-layer stack at S 2, v 2
        # is semantic layer 2 (chunk 1 of stage 0).
        np.testing.assert_array_equal(
            got["blocks.2.attn.qkv.weight"].numpy(),
            np.asarray(params["blocks_qkv_k"][1]).T)


VALIDATIONS = [
    ("attention", dict(attention="ring"), dict(pipe=2)),
    ("moe", dict(moe_experts=4), dict(pipe=2)),
    ("interleaved_pipe1", dict(pp_schedule="interleaved"), dict(pipe=1)),
    ("virtual1", dict(pp_schedule="interleaved", pp_virtual=1),
     dict(pipe=2)),
    ("chunks", dict(pp_schedule="interleaved", vit_depth=6), dict(pipe=2)),
    ("micro", dict(pp_schedule="interleaved", pp_microbatches=3),
     dict(pipe=2)),
    ("remat", dict(remat=True), dict(pipe=2)),
    ("depth", dict(vit_depth=3), dict(pipe=2))]


@pytest.mark.parametrize("fields,mesh", [v[1:] for v in VALIDATIONS],
                         ids=[v[0] for v in VALIDATIONS])
def test_vit_pp_validation_messages_are_tpunets(fields, mesh):
    cfg = dict(VITPP, **fields)
    with pytest.raises(ValueError) as want:
        jax_create_model(JaxModelConfig(**cfg),
                         mesh=jax_make_mesh(JaxMeshConfig(data=1, **mesh)))
    _fake_mesh(**mesh)
    try:
        with pytest.raises(ValueError) as got:
            create_model(ModelConfig(**cfg), device="cpu", image_size=SIZE)
    finally:
        set_mesh(None)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("vitpp")
    two = ["--preset", "distributed", "--model", "vit_pp", "--mesh-pipe",
           "2"] + VIT_FLAGS
    flags = {f"vitpp_{tag}": two + ["--pp-schedule", sched,
                                    "--dropout-rate", "0"]
             for tag, sched in (("gpipe", "gpipe"), ("1f1b", "1f1b"),
                                ("ileave", "interleaved"))}
    flags["vitpp_drop"] = two + ["--pp-schedule", "1f1b", "--dropout-rate",
                                 "0.1"]
    one = cli.run(["--preset", "single", "--model", "vit"] + VIT_FLAGS + [
        "--dropout-rate", "0", "--checkpoint-dir", str(d / "one")])
    ref = dict(train={"loss": one.history[0]["train_loss"]},
               test={"accuracy": one.history[0]["test_accuracy"]},
               params={k: v.numpy() for k, v in torch.load(
                   d / "one" / "state.pt")["model"].items()})
    _, got = run_gangs(d, flags, [(2, ["vitpp_gpipe", "vitpp_drop"]),
                                  (2, ["vitpp_1f1b", "vitpp_ileave"])], {})
    return dict(d=d, want=ref, got=got)


@pytest.mark.parametrize("name", ["vitpp_gpipe", "vitpp_1f1b",
                                  "vitpp_ileave"])
def test_vit_pp_epoch_matches_the_one_process_vit(gang, name):
    dumps = gang["got"][name]
    whole = check_pp_ranks(gang["d"], name, dumps)
    for dump in dumps:
        check_epoch(dump["history"], whole, gang["want"], name)


def test_vit_pp_with_dropout_keeps_its_replicas(gang):
    dumps = gang["got"]["vitpp_drop"]
    check_pp_ranks(gang["d"], "vitpp_drop", dumps)
    loss = dumps[0]["history"][0]["train_loss"]
    assert np.isfinite(loss) and loss != gang["want"]["train"]["loss"]
