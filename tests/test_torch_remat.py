"""Remat in the port, on the CPU.

- ``remat`` (``torch.utils.checkpoint`` of each encoder block, training
  only): the ViT and the LM at dropout 0.2 give the logits and every
  gradient of the same model without remat to the bit (each block's
  dropout masks are drawn again from the generator state before the
  block), and the attention core runs twice a layer a step; at dropout
  0 the ViT with remat matches tpunet's ``nn.remat`` ViT
  (tests/test_vit.py:83) within tests/test_torch_vit.py's tolerances
  (loss 1e-5 relative, every gradient within 1e-5 of the largest); eval
  forwards and the LM's decode steps are never wrapped.
- ``block_remat`` (MobileNetV2, tpunet's saved-residual policy): the
  logits, every gradient and the BN running statistics equal those
  without it to the bit, in float32 and bfloat16, with and without the
  hand kernels' plain versions, while the tensors kept for the backward
  shrink (the epilogues' activations are recomputed, no conv runs
  again).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.models import create_model as jax_create_model
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model, mobilenetv2
from tpunet_torch.models.convert import load_state_dict, vit_state_dict_from_jax
from tpunet_torch.utils.prng import step_generator

from test_torch_vit import SIZE, VIT, _images, jax_vit  # noqa: F401
import _torch_threads  # noqa: E402,F401

LM = dict(name="lm", vit_hidden=32, vit_depth=2, vit_heads=2, vocab_size=64,
          max_seq_len=32, dtype="float32")


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _pair(cfg, **kw):
    """(model without remat, the same weights with remat)."""
    gen = torch.Generator().manual_seed(7)
    plain = create_model(ModelConfig(**cfg), device="cpu", generator=gen,
                         **kw)
    remat = create_model(ModelConfig(remat=True, **cfg), device="cpu", **kw)
    remat.load_state_dict(plain.state_dict())
    if "vit_patch" in cfg:
        with torch.no_grad():   # Flax's zero head: draw it
            for m in (plain, remat):
                m.classifier.weight.copy_(torch.randn(
                    m.classifier.weight.shape,
                    generator=torch.Generator().manual_seed(1)))
    return plain, remat


def _count_cores(model):
    calls = []
    core = model.attn_fn

    def counted(*a, **kw):
        calls.append(1)
        return core(*a, **kw)
    model.attn_fn = counted
    return calls


@pytest.mark.parametrize("family", ["vit", "lm"])
def test_remat_at_dropout_gives_the_same_logits_and_gradients(family):
    if family == "vit":
        cfg, kw = dict(VIT, dropout_rate=0.2), {"image_size": SIZE}
        x = torch.from_numpy(_images(4, 3)).permute(0, 3, 1, 2)
        y = torch.arange(4)
    else:
        cfg, kw = dict(LM, dropout_rate=0.2), {}
        x = torch.randint(0, 64, (4, 32),
                          generator=torch.Generator().manual_seed(2))
    out = []
    for model in _pair(cfg, **kw):
        calls = _count_cores(model)
        logits = model(x, train=True, generator=step_generator(3, 5))
        forward_calls = len(calls)
        if family == "vit":
            loss = F.cross_entropy(logits, y)
        else:
            loss = F.cross_entropy(logits[:, :-1].reshape(-1, 64),
                                   x[:, 1:].reshape(-1))
        loss.backward()
        out.append((logits.detach(), _grads(model), forward_calls,
                    len(calls)))
    (l0, g0, f0, c0), (l1, g1, f1, c1) = out
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    # One core a layer in the forward; remat runs it again in the
    # backward (the flash forward's second launch on the card).
    assert (f0, c0) == (2, 2) and (f1, c1) == (2, 4)


def test_remat_vit_matches_tpunets_remat_model(jax_vit):  # noqa: F811
    _, params = jax_vit
    jmodel = jax_create_model(JaxModelConfig(attention="dense",
                                             dropout_rate=0.0, remat=True,
                                             **VIT))
    x = _images(4, 2)
    y = np.arange(4, dtype=np.int32)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    model = create_model(ModelConfig(attention="dense", dropout_rate=0.0,
                                     remat=True, **VIT),
                         device="cpu", image_size=SIZE)
    assert load_state_dict(model, vit_state_dict_from_jax(params))
    logits = model(torch.from_numpy(x).permute(0, 3, 1, 2), train=True,
                   generator=torch.Generator())
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, p in model.named_parameters():
        assert float((p.grad - want[k]).abs().max()) <= 1e-5 * gmax, k


def test_eval_and_decode_are_never_wrapped(monkeypatch):
    import torch.utils.checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ckpt, "checkpoint", counted)
    _, lm = _pair(dict(LM, dropout_rate=0.0))
    tokens = torch.randint(0, 64, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        lm(tokens)
        cache = lm.init_cache(2, 32)
        for i in range(3):
            _, cache = lm(tokens[:, i:i + 1], cache=cache, pos_offset=i)
    lm(tokens)                           # eval with autograd on
    assert calls == []
    lm(tokens, train=True, generator=torch.Generator())
    assert len(calls) == 2               # one a block


# -- MobileNetV2 block remat ----------------------------------------------------


def _mobilenet_step(block_remat, dtype, pallas):
    model = create_model(
        ModelConfig(dtype=dtype, width_mult=0.5, dropout_rate=0.2,
                    use_pallas_depthwise=pallas, fused_ir=pallas,
                    block_remat=block_remat),
        device="cpu", generator=torch.Generator().manual_seed(3))
    x = torch.randn(8, 3, SIZE, SIZE,
                    generator=torch.Generator().manual_seed(1))
    kept = {}

    def pack(t):
        kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        # The outer hooks see what the stem, the head and the classifier
        # keep; inside a block under block remat the block's own hooks
        # take over, so count those through EpilogueRemat.pack.
        logits = model(x, train=True, generator=step_generator(0, 0))
    F.cross_entropy(logits, torch.arange(8)).backward()
    return model, logits.detach(), kept


@pytest.mark.parametrize("dtype,pallas", [
    ("float32", True), ("bfloat16", True), ("float32", False)],
    ids=["f32_kernels", "bf16_kernels", "f32_conv2d"])
def test_block_remat_gives_the_same_gradients_and_bn_buffers(
        dtype, pallas, monkeypatch):
    recipes, tensors = {}, {}
    real_pack = mobilenetv2.EpilogueRemat.pack

    def pack(self, t):
        out = real_pack(self, t)
        st = t.untyped_storage()
        (recipes if isinstance(out, tuple) else tensors)[st.data_ptr()] = \
            st.nbytes()
        return out
    monkeypatch.setattr(mobilenetv2.EpilogueRemat, "pack", pack)
    plain, l0, kept0 = _mobilenet_step(False, dtype, pallas)
    remat, l1, kept1 = _mobilenet_step(True, dtype, pallas)
    assert torch.equal(l0, l1)
    g0, g1 = _grads(plain), _grads(remat)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    b0, b1 = dict(plain.named_buffers()), dict(remat.named_buffers())
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
    # Without block remat every saved tensor reaches the outer hooks;
    # with it, the blocks' tensors reach EpilogueRemat: the epilogues'
    # activations go as recipes (which hold the conv outputs), and the
    # storages kept as they are shrink.
    assert recipes
    assert sum(kept1.values()) + sum(tensors.values()) < sum(kept0.values())


def test_block_remat_frees_the_epilogue_activations(monkeypatch):
    """In bf16, the storage of every tensor a block registers as
    recomputable (the float32 copy of a conv output, the normalised
    value, the activation the next conv reads) is freed once the forward
    is over: only the recipes hold the conv outputs."""
    import gc
    import weakref

    refs = []
    real = mobilenetv2.EpilogueRemat.register

    def register(self, t, make):
        refs.append(weakref.ref(t.untyped_storage()))
        return real(self, t, make)
    monkeypatch.setattr(mobilenetv2.EpilogueRemat, "register", register)
    model = create_model(
        ModelConfig(dtype="bfloat16", width_mult=0.5, dropout_rate=0.0,
                    use_pallas_depthwise=True, block_remat=True),
        device="cpu")
    x = torch.randn(8, 3, SIZE, SIZE,
                    generator=torch.Generator().manual_seed(1))
    logits = model(x, train=True, generator=torch.Generator())
    gc.collect()
    # Registered a block: the expand's activation (16 blocks expand),
    # the depthwise BN's float32 copy, normalised value and activation,
    # and the project's output. Only the 7 blocks without a residual
    # keep theirs: it is the block's output, which the next block keeps
    # as its input.
    assert len(refs) == 16 + 3 * 17 + 17
    no_residual = sum(not b.use_res for b in list(model.features)[1:-1])
    assert no_residual == 7
    alive = [r for r in refs if r() is not None]
    assert len(alive) == no_residual
    F.cross_entropy(logits, torch.arange(8)).backward()
