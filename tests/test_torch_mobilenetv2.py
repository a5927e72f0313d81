"""Parity of the port's MobileNetV2 eval forward with tpunet's.

Seeded tpunet variables (BN statistics made non-trivial, see
tests/_torch_port.py) are carried across with ``state_dict_from_jax``;
the port's float32 eval logits must equal ``model.apply(..., train=False)``
to 1e-4, the tolerance of tests/test_convert.py, with the depthwise path
on and off. With it on, the JAX side runs the Pallas kernel in interpret
mode through the monkeypatch of tests/test_ops.py, and the port's
wrapper runs its plain version on the CPU. Also: the port's state dict
is torchvision's key layout, and ``module.``/wrapped/1000-class
checkpoints load as ``convert_torch_state_dict`` loads them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunet.ops as jops
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.models import create_model as jax_create_model
from tpunet.models import num_params as jax_num_params
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model, num_params
from tpunet_torch.models.convert import (load_state_dict, load_state_dict_file,
                                         state_dict_from_jax)
from torch_ref_mobilenetv2 import TorchMobileNetV2

from _torch_port import SIZE, WIDTH, jax_variables, nchw, port_model
import _torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def variables():
    return jax_variables(seed=0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "depthwise"])
def test_eval_logits_match_tpunet(variables, images, pallas, monkeypatch):
    params, stats = variables
    if pallas:
        orig = jops.depthwise_conv3x3
        monkeypatch.setattr(
            jops, "depthwise_conv3x3",
            lambda x, w, stride=1, interpret=None: orig(x, w, stride, True))
    jmodel = jax_create_model(JaxModelConfig(
        dtype="float32", width_mult=WIDTH, use_pallas_depthwise=pallas))
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(images), train=False))
    # The comparison means something only if the logits are not tiny.
    assert np.abs(want).max() > 1e-2
    model = port_model(params, stats, use_pallas_depthwise=pallas)
    with torch.no_grad():
        got = model(nchw(images)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_param_count_matches_tpunet():
    """2,236,682 at width 1.0 with 10 classes, the reference's count."""
    full = create_model(ModelConfig(), device="cpu")
    assert num_params(full) == 2_236_682
    jmodel = jax_create_model(JaxModelConfig(dtype="float32",
                                             width_mult=WIDTH))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    half = create_model(ModelConfig(width_mult=WIDTH), device="cpu")
    assert num_params(half) == jax_num_params(shapes["params"])


def test_state_dict_loads_strictly_into_torchvision_layout():
    """The port's keys are torchvision's: its state dict loads strictly
    into the torch oracle, and the oracle's BN-calibrated weights load
    back with equal f32 eval logits."""
    port = create_model(ModelConfig(dtype="float32"), device="cpu")
    ref = TorchMobileNetV2(num_classes=10)
    ref.load_state_dict(port.state_dict(), strict=True)
    torch.manual_seed(0)
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # cumulative average: one pass = batch stats
            m.reset_running_stats()
    ref.train()
    with torch.no_grad():
        ref(torch.randn(4, 3, SIZE, SIZE))
    ref.eval()
    assert load_state_dict(port, ref.state_dict())
    x = torch.randn(2, 3, SIZE, SIZE)
    with torch.no_grad():
        want = ref(x)
        got = port(x)
    assert want.abs().max() > 1e-2
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_module_prefix_and_imagenet_head(variables):
    """A DDP ``module.``-prefixed checkpoint with a 1000-class head loads
    its backbone and leaves the fresh 10-class head, as
    ``convert_torch_state_dict`` does."""
    params, stats = variables
    sd = state_dict_from_jax(params, stats)
    sd["classifier.1.weight"] = torch.randn(1000, sd["classifier.1.weight"].shape[1])
    sd["classifier.1.bias"] = torch.randn(1000)
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                         device="cpu")
    head = model.classifier[1].weight.detach().clone()
    assert not load_state_dict(model, {f"module.{k}": v for k, v in sd.items()})
    torch.testing.assert_close(model.classifier[1].weight.detach(), head)
    torch.testing.assert_close(model.features[0][0].weight.detach(),
                               sd["features.0.0.weight"])


@pytest.mark.parametrize("wrapper", [None, "state_dict", "model"])
def test_load_state_dict_file_unwraps(variables, tmp_path, wrapper, images):
    params, stats = variables
    sd = state_dict_from_jax(params, stats)
    path = tmp_path / "ck.pth"
    torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3}, path)
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                         device="cpu")
    assert load_state_dict_file(str(path), model)
    with torch.no_grad():
        got = model(nchw(images))
        want = port_model(params, stats)(nchw(images))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_derived_constants_follow_parameter_changes(variables, images):
    """Cast weights and eval-BN constants are computed once, hold no
    autograd history, and are recomputed after an in-place edit or a
    load_state_dict: the logits then equal a fresh model's."""
    params, stats = variables
    model = port_model(params, stats, use_pallas_depthwise=True)
    x = nchw(images)
    with torch.inference_mode():
        first = model(x)
    assert model._consts
    assert not any(t.grad_fn is not None or t.is_inference()
                   for _, _, consts in model._consts.values() for t in consts)
    with torch.no_grad():
        model.features[2].conv[1][1].running_var.mul_(2.0)
        model.features[2].conv[1][0].weight.mul_(1.5)
        edited = model(x)
    fresh = create_model(ModelConfig(dtype="float32", width_mult=WIDTH,
                                     use_pallas_depthwise=True), device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert not torch.equal(edited, first)
        torch.testing.assert_close(edited, fresh(x), rtol=0, atol=0)
        load_state_dict(model, state_dict_from_jax(params, stats))
        torch.testing.assert_close(model(x), first, rtol=0, atol=0)


def test_state_dict_mismatch_raises(variables):
    params, stats = variables
    sd = state_dict_from_jax(params, stats)
    del sd["features.1.conv.1.weight"]
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                         device="cpu")
    with pytest.raises(RuntimeError, match="features.1.conv.1.weight"):
        load_state_dict(model, sd)


def test_train_mode_and_unported_models_raise():
    """Train mode (ported in slice 2) raises without the generator its
    dropout mask is drawn from and runs with one; unported models raise
    with their ROADMAP item."""
    model = create_model(ModelConfig(dtype="float32", width_mult=WIDTH),
                         device="cpu")
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(2, 3, SIZE, SIZE), train=True)
    out = model(torch.randn(2, 3, SIZE, SIZE), train=True,
                generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="unknown pp_schedule"):
        ModelConfig(name="lm_pp", pp_schedule="zigzag")
    with pytest.raises(ValueError):
        ModelConfig(name="resnet50")
    assert dataclasses.asdict(ModelConfig()) == {
        k: v for k, v in dataclasses.asdict(JaxModelConfig()).items()
        if k in dataclasses.asdict(ModelConfig())}
