"""Parity of the port's ViT slice with tpunet's, on the CPU.

A tiny float32 ViT (32 px, patch 4, hidden 32, depth 2, 2 heads, head
dim 16): tpunet's init, with the zero classifier, the LayerNorms and the
biases redrawn from numpy (a zero classifier gives zero logits and zero
gradients above the head, and any comparison would pass). The weights
cross with ``vit_state_dict_from_jax``; then

- logits against tpunet's ViT, with tpunet's dense core and with its
  flash kernel in interpret mode (blocks of 16 over 64 tokens), the port
  with ``attention`` dense and flash: 1e-5, float32 sums in another
  order;
- one train-mode forward/backward with dropout 0 against tpunet's train
  step math (``model.apply(train=True)``, mean softmax cross-entropy,
  ``jax.value_and_grad``): the loss to 1e-5 relative, every gradient
  within 1e-5 of the largest (no BatchNorm: the float32 gradients are
  well conditioned);
- ``Predictor`` probabilities against tpunet's ``Predictor`` on the same
  weights and uint8 images, 1e-5;
- config refusals name their ROADMAP items;
- the training CLI for one epoch, whose ``best.pth`` evaluates (and
  ``--eval-only`` reports) the epoch's test accuracy, and a resumed run
  that equals an uninterrupted one to the bit.
"""

import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpunet.config import DataConfig as JaxDataConfig
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.infer.predict import Predictor as JaxPredictor
from tpunet.models import create_model as jax_create_model
from tpunet.models import init_variables, num_params as jax_num_params
from tpunet.models.vit import ViT as JaxViT
from tpunet.ops.flash import flash_attention as jax_flash_attention
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 TrainConfig)
from tpunet_torch.infer.predict import Predictor
from tpunet_torch.models import create_model, num_params
from tpunet_torch.models.convert import (load_state_dict,
                                         load_state_dict_file,
                                         vit_state_dict_from_jax)
from tpunet_torch.train import __main__ as cli
from tpunet_torch.train.loop import Trainer

SIZE = 32
VIT = dict(name="vit", vit_patch=4, vit_hidden=32, vit_depth=2, vit_heads=2,
           dtype="float32")
CLI_VIT = ["--model", "vit", "--vit-patch", "4", "--vit-hidden", "32",
           "--vit-depth", "2", "--vit-heads", "2"]


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v, np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_vit():
    """(tpunet ViT with the dense core, its params as numpy)."""
    model = jax_create_model(JaxModelConfig(attention="dense",
                                            dropout_rate=0.0, **VIT))
    v = jax.jit(lambda key: init_variables(model, key, image_size=SIZE))(
        jax.random.PRNGKey(0))
    params = _plain(v["params"])
    rng = np.random.default_rng(0)

    def redraw(tree):
        for k, node in tree.items():
            if not isinstance(node, dict):
                continue
            if "scale" in node:              # a LayerNorm
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


def _port(params, attention="auto", dropout_rate=0.0):
    model = create_model(ModelConfig(attention=attention,
                                     dropout_rate=dropout_rate, **VIT),
                         device="cpu", image_size=SIZE)
    assert load_state_dict(model, vit_state_dict_from_jax(params))
    return model


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, SIZE, SIZE, 3)).astype(np.float32)


def test_weights_carry_across(jax_vit):
    _, params = jax_vit
    sd = vit_state_dict_from_jax(params)
    model = create_model(ModelConfig(**VIT), device="cpu", image_size=SIZE)
    assert set(sd) == set(model.state_dict())
    assert load_state_dict(model, sd)
    assert num_params(model) == jax_num_params(params)
    kernel = params["block00"]["attn"]["qkv"]["kernel"]
    np.testing.assert_array_equal(
        model.blocks[0].attn.qkv.weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(
        model.patch_embed.weight.detach().numpy(),
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(model.ln.weight.detach().numpy(),
                                  params["ln"]["scale"])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_tpunet(jax_vit, attention):
    model, params = jax_vit
    if attention == "flash":
        model = JaxViT(num_classes=10, patch_size=4, hidden=32, depth=2,
                       heads=2, attn_fn=functools.partial(
                           jax_flash_attention, block_q=16, block_k=16,
                           interpret=True),
                       dtype=jnp.float32, param_dtype=jnp.float32)
    x = _images(2, 1)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                  train=False))
    port = _port(params, attention)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.dtype == np.float32 and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_train_step_loss_and_every_gradient_match_tpunet(jax_vit):
    model, params = jax_vit
    x = _images(8, 2)
    y = np.arange(8) % 10

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = vit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    port = _port(params)                      # attention auto: flash
    loss = F.cross_entropy(port(torch.from_numpy(x).permute(0, 3, 1, 2),
                                train=True, generator=torch.Generator()),
                           torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    names = dict(port.named_parameters())
    assert set(names) == set(want)
    gmax = max(float(g.abs().max()) for g in want.values())
    assert gmax > 1e-2
    for key, p in names.items():
        err = float((p.grad - want[key]).abs().max())
        assert err <= 1e-5 * gmax, (key, err, gmax)


def test_dropout_draws_from_the_step_generator():
    model = create_model(ModelConfig(dropout_rate=0.5, **VIT), device="cpu",
                         image_size=SIZE)
    with torch.no_grad():                     # not the zero init
        model.classifier.weight.normal_(
            0.0, 0.5, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_images(2, 3)).permute(0, 3, 1, 2)
    a = model(x, train=True, generator=torch.Generator().manual_seed(1))
    b = model(x, train=True, generator=torch.Generator().manual_seed(1))
    c = model(x, train=True, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)


def test_predictor_probs_match_tpunet(jax_vit):
    _, params = jax_vit
    jpred = JaxPredictor(
        model_cfg=JaxModelConfig(attention="dense", dropout_rate=0.0, **VIT),
        data_cfg=JaxDataConfig(image_size=SIZE), variables={"params": params})
    pred = Predictor(ModelConfig(**VIT), DataConfig(image_size=SIZE),
                     state_dict=vit_state_dict_from_jax(params), device="cpu")
    for hw in [(20, 24), (48, 64)]:
        img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3),
                                                    np.uint8)
        want = jpred.predict_probs(img)
        assert want.max() - want.min() > 1e-2
        np.testing.assert_allclose(pred.predict_probs(img), want, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("make,item", [
    (lambda: ModelConfig(name="vit", moe_experts=4), "item 8"),
    (lambda: ModelConfig(name="vit", moe_top_k=1), "item 8"),
    (lambda: ModelConfig(name="vit", remat=True), "item 2b"),
    (lambda: ModelConfig(name="vit", attention="ring"), "item 8"),
    (lambda: ModelConfig(name="vit", attention="ulysses"), "item 8"),
    (lambda: ModelConfig(name="vit", attention_core="flash"), "item 8"),
    (lambda: ModelConfig(name="lm", vocab_ce="sharded"), "item 8"),
    (lambda: ModelConfig(name="lm_pp"), "item 8"),
    (lambda: ModelConfig(name="vit_pp"), "item 8")],
    ids=["moe", "moe_top_k", "remat", "ring", "ulysses", "core", "lm",
         "lm_pp", "vit_pp"])
def test_config_refusals_name_their_roadmap_item(make, item):
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue A {item}"):
        make()


def test_config_keeps_mobilenet_fields_to_mobilenet():
    for kw in (dict(width_mult=0.5), dict(use_pallas_depthwise=True),
               dict(fused_ir=False)):
        with pytest.raises(ValueError, match="MobileNetV2 field"):
            ModelConfig(name="vit_base", **kw)
    with pytest.raises(ValueError, match="unknown attention"):
        ModelConfig(name="vit", attention="sparse")
    assert ModelConfig(name="vit_base").attention == "auto"


def _cli(directory, *extra):
    return cli.main(["--preset", "serial", *CLI_VIT, "--dataset",
                     "synthetic", "--synthetic-size", "48", "--image-size",
                     str(SIZE), "--batch-size", "16", "--eval-batch-size",
                     "20", "--dtype", "float32", "--device", "cpu",
                     "--checkpoint-dir", str(directory), *extra])


def test_cli_epoch_best_pth_and_eval_only(tmp_path, capsys):
    assert _cli(tmp_path, "--epochs", "1") == 0
    out = capsys.readouterr().out
    assert re.search(r"^Epoch 1/1 Time: .* Test Acc: [\d.]+$", out, re.M)
    record = [json.loads(line) for line in (tmp_path / "metrics.jsonl")
              .read_text().splitlines() if '"kind"' not in line][-1]
    cfg, _ = cli.config_from_args(["--preset", "serial", *CLI_VIT,
                                   "--image-size", str(SIZE)])
    model = create_model(cfg.model, device="cpu", image_size=SIZE)
    assert load_state_dict_file(str(tmp_path / "best.pth"), model)
    trainer = Trainer(TrainConfig(
        data=DataConfig(dataset="synthetic", image_size=SIZE, batch_size=16,
                        eval_batch_size=20, synthetic_train_size=48,
                        synthetic_test_size=12),
        model=dataclasses.replace(cfg.model, dtype="float32"),
        checkpoint=CheckpointConfig(directory=str(tmp_path)),
        eval_only=True), device="cpu")
    assert trainer.evaluate_checkpoint()["accuracy"] == record[
        "test_accuracy"]
    assert _cli(tmp_path, "--eval-only") == 0
    found = re.search(r"Eval: Test Loss: [\d.]+ Test Acc: ([\d.]+)",
                      capsys.readouterr().out)
    assert found and float(found.group(1)) == pytest.approx(
        record["test_accuracy"], abs=5e-5)


def test_resume_of_a_vit_run_is_bit_exact(tmp_path):
    def cfg(directory, epochs, resume=False):
        return TrainConfig(
            epochs=epochs, seed=3,
            data=DataConfig(dataset="synthetic", image_size=SIZE,
                            batch_size=16, synthetic_train_size=48,
                            synthetic_test_size=12),
            model=ModelConfig(**VIT),
            checkpoint=CheckpointConfig(directory=str(directory),
                                        resume=resume))

    full = Trainer(cfg(tmp_path / "a", 2), device="cpu")
    history = full.train()
    Trainer(cfg(tmp_path / "b", 1), device="cpu").train()
    resumed = Trainer(cfg(tmp_path / "b", 2, resume=True), device="cpu")
    assert resumed.start_epoch == 2
    assert resumed.train()[0]["test_loss"] == history[1]["test_loss"]
    a, b = full.state.model.state_dict(), resumed.state.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
