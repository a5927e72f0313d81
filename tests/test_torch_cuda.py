"""Card-only tests of the port: each hand-written kernel against its plain
version, and the model, the train step and the Predictor on the card.

Marked ``cuda``; each skips without a CUDA device. This file imports no
JAX and nothing of tpunet, so that it runs on a machine with PyTorch and
no JAX (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import tpunet_torch.models.mobilenetv2 as mnv2
from tpunet_torch.config import DataConfig, ModelConfig
from tpunet_torch.infer.predict import Predictor
from tpunet_torch.models import create_model
from tpunet_torch.ops import depthwise_conv3x3, depthwise_conv3x3_reference
from tpunet_torch.ops import depthwise as dwmod
from tpunet_torch.ops import fused_ir

pytestmark = pytest.mark.cuda

# (n, h, w, c, stride), as tests/test_torch_depthwise.py, plus a
# MobileNetV2 shape.
SHAPES = [
    (2, 8, 8, 8, 1), (2, 8, 8, 8, 2), (1, 9, 7, 24, 2), (2, 7, 9, 24, 1),
    (1, 11, 11, 40, 2), (2, 6, 6, 40, 1), (1, 5, 5, 12, 2),
    (2, 56, 56, 144, 2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(shape, seed, dtype):
    n, h, w, c, _ = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, h, w, c, generator=g).to("cuda", dtype),
            torch.randn(3, 3, c, generator=g).to("cuda", dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_depthwise_kernel_equals_plain(cuda, shape, dtype):
    """The kernel repeats the plain version's arithmetic (same tap order,
    no fused multiply-add), so the two agree to the bit."""
    x, w = _inputs(shape, 0, dtype)
    before = depthwise_conv3x3.launches
    got = depthwise_conv3x3(x, w, shape[-1])
    assert depthwise_conv3x3.launches == before + 1
    want = depthwise_conv3x3_reference(x, w, shape[-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_depthwise_unaligned_input_takes_scalar_path(cuda):
    """C % 8 == 0 but x not 16-byte aligned: the scalar path, same result."""
    x, w = _inputs((2, 9, 9, 16, 2), 1, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    torch.testing.assert_close(depthwise_conv3x3(xu, w, 2),
                               depthwise_conv3x3_reference(x, w, 2),
                               rtol=0, atol=0)


def test_model_kernel_path_equals_plain_path(cuda, monkeypatch):
    """Width 0.5 bf16 MobileNetV2: 17 launches per forward, and the same
    logits as with the plain depthwise version on the card."""
    model = create_model(ModelConfig(width_mult=0.5,
                                     use_pallas_depthwise=True))
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    x = x.to("cuda").contiguous(memory_format=torch.channels_last)
    before = depthwise_conv3x3.launches
    with torch.inference_mode():
        got = model(x)
    assert depthwise_conv3x3.launches == before + 17
    monkeypatch.setattr(mnv2, "depthwise_conv3x3", depthwise_conv3x3_reference)
    with torch.inference_mode():
        want = model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_predictor_on_card_agrees_with_cpu(cuda):
    """Float32 on both sides: the card's Predictor and the CPU's give the
    same probabilities up to summation order (cuDNN vs the CPU's convs)."""
    cfg = ModelConfig(dtype="float32", width_mult=0.5,
                      use_pallas_depthwise=True)
    data = DataConfig(image_size=64)
    gpu = Predictor(cfg, data, device="cuda")
    cpu = Predictor(cfg, data, device="cpu")
    img = np.random.default_rng(3).integers(0, 256, (48, 80, 3), np.uint8)
    np.testing.assert_allclose(gpu.predict_probs(img), cpu.predict_probs(img),
                               rtol=1e-4, atol=1e-5)


def _bf16_ulp(v):
    e = torch.floor(torch.log2(v.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_depthwise_backward_kernel_vs_plain(cuda, shape, dtype):
    """dx repeats the plain version's tap order: equal to the bit. dw sums
    the same products in another order: within 1e-5 of the sum of their
    magnitudes, plus one bf16 ulp when the result is rounded to bf16."""
    n, h, w, c, s = shape
    x, wt = _inputs(shape, 3, dtype)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    g = torch.randn(n, ho, wo, c, generator=torch.Generator().manual_seed(4)
                    ).to("cuda", dtype)
    before = dwmod.depthwise_conv3x3_backward.launches
    dx, dw = dwmod.depthwise_conv3x3_backward(x, wt, g, s)
    assert dwmod.depthwise_conv3x3_backward.launches == before + 1
    pdx, pdw = dwmod.depthwise_conv3x3_backward_reference(x, wt, g, s)
    _, mag = dwmod.depthwise_conv3x3_backward_reference(x.abs(), wt, g.abs(), s)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == dtype
    torch.testing.assert_close(dx, pdx, rtol=0, atol=0)
    tol = 1e-5 * mag + (_bf16_ulp(pdw) if dtype == torch.bfloat16 else 0)
    assert bool(((dw.float() - pdw).abs() <= tol).all())


# (m, ci, co): MobileNetV2 widths, and Ci/Co off a multiple of 8 with M
# off a multiple of the 64-row tile.
FUSED = [(128, 16, 24), (63, 13, 24), (25, 8, 10), (8 * 196, 96, 576),
         (8 * 49, 960, 320), (1000, 144, 24)]


def _fused_inputs(m, ci, co, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, ci, generator=gen).to("cuda", dtype)
    w = (torch.randn(ci, co, generator=gen) / ci ** 0.5).to("cuda", dtype)
    return x, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", FUSED, ids=str)
def test_fused_ir_forward_kernel_vs_plain(cuda, shape, dtype):
    """y: float32 sums of Ci products in another order, within 1e-5 of the
    sum of their magnitudes (plus one bf16 ulp after rounding); the
    column sums of the rounded y within 1e-5 of the sum of |y|, |y|^2."""
    m, ci, co = shape
    x, w = _fused_inputs(m, ci, co, dtype, 5)
    before = fused_ir.fused_ir_forward.launches
    y, s = fused_ir.fused_ir_forward(x, w)
    assert fused_ir.fused_ir_forward.launches == before + 1
    py, ps = fused_ir.fused_ir_forward_reference(x, w)
    mag = x.float().abs() @ w.float().abs()
    torch.cuda.synchronize()
    tol = 1e-5 * mag + (_bf16_ulp(py.float()) if dtype == torch.bfloat16 else 0)
    assert bool(((y.float() - py.float()).abs() <= tol).all())
    yb = y.float()
    want = torch.stack([yb.sum(0), (yb * yb).sum(0)])
    smag = torch.stack([yb.abs().sum(0), (yb * yb).sum(0)])
    assert bool(((s - want).abs() <= 1e-5 * smag + 1e-30).all())


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", FUSED, ids=str)
def test_fused_ir_backward_kernel_vs_plain(cuda, shape, dtype, act):
    """dx and dw: float32 sums of products of t (equal on both sides) in
    another order, within 1e-5 of the sum of their magnitudes (dx plus
    one bf16 ulp after rounding)."""
    m, ci, co = shape
    x, w = _fused_inputs(m, ci, co, dtype, 6)
    gen = torch.Generator().manual_seed(7)
    y = (torch.randn(m, co, generator=gen) * 2).to("cuda", dtype)
    g = torch.randn(m, co, generator=gen).to("cuda", dtype)
    chan = torch.stack([torch.rand(co, generator=gen) + 0.5,
                        torch.randn(co, generator=gen) * 3,
                        torch.rand(co, generator=gen) + 0.5,
                        torch.randn(co, generator=gen),
                        torch.randn(co, generator=gen) * 0.1,
                        torch.randn(co, generator=gen) * 0.1]).cuda()
    before = fused_ir.fused_ir_backward.launches
    dx, dw = fused_ir.fused_ir_backward(x, g, y, w, chan, act)
    assert fused_ir.fused_ir_backward.launches == before + 1
    pdx, pdw = fused_ir.fused_ir_backward_reference(x, g, y, w, chan, act)
    t = fused_ir.grad_conv_out(g, y, chan, act).abs()
    torch.cuda.synchronize()
    tol = 1e-5 * (t @ w.float().abs().t())
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(pdx.float())
    assert bool(((dx.float() - pdx.float()).abs() <= tol).all())
    assert bool(((dw - pdw).abs() <= 1e-5 * (x.float().abs().t() @ t)
                 + 1e-30).all())


def test_fused_ir_op_on_card_agrees_with_plain_op(cuda):
    """conv1x1_bn_act through the kernels against the plain composition,
    float32: outputs, statistics and the four gradients."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(4, 14, 14, 96, generator=gen).cuda()
    w = (torch.randn(96, 144, generator=gen) * 0.1).cuda()
    sc = (1 + 0.3 * torch.randn(144, generator=gen)).cuda()
    bi = (0.1 * torch.randn(144, generator=gen)).cuda()
    g = torch.randn(4, 14, 14, 144, generator=gen).cuda()
    got = [t.clone().requires_grad_() for t in (x, w, sc, bi)]
    want = [t.clone().requires_grad_() for t in (x, w, sc, bi)]
    out, mean, var = fused_ir.conv1x1_bn_act(*got, True, 1e-5)
    pout, pmean, pvar = fused_ir.conv1x1_bn_act_reference(*want, True, 1e-5)
    torch.testing.assert_close(out, pout, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mean, pmean, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, pvar, rtol=1e-4, atol=1e-5)
    (out * g).sum().backward()
    (pout * g).sum().backward()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-3, atol=1e-3)


def _train_grads(model, x, y):
    model.zero_grad(set_to_none=True)
    out = model(x, train=True, generator=torch.Generator().manual_seed(0))
    torch.nn.functional.cross_entropy(out, y).backward()
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _grad_errors(got, want):
    """Per parameter ||got - want|| / ||want||; a BN bias (the project
    BNs' have a true gradient of 0) against its BN weight's norm."""
    out = {}
    for k, g in want.items():
        scale = g.norm()
        w = k[:-5] + ".weight"
        if k.endswith(".bias") and w in want and want[w].shape == g.shape:
            scale = torch.maximum(scale, want[w].norm())
        out[k] = ((got[k] - g).norm() / scale.clamp_min(1e-30)).item()
    return out


def test_train_step_on_card_launches_and_matches_plain(cuda, monkeypatch):
    """Width 0.5, 64 px, 8 images, float32: one train forward/backward
    launches 17 + 17 + 33 + 33 kernels. Its gradients are compared with
    those of the plain versions on the card; the backward through 52
    train-mode BNs amplifies rounding differences, so the yardstick is
    the same step through cuDNN and F.conv2d (fused_ir and the depthwise
    kernels off): the kernels' median and largest error at most twice
    that path's, plus 1e-5."""
    cfg = ModelConfig(dtype="float32", width_mult=0.5,
                      use_pallas_depthwise=True, fused_ir=True)
    model = create_model(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(8, 3, 64, 64, generator=gen).cuda()
    y = torch.randint(0, 10, (8,), generator=gen).cuda()
    counters = (dwmod.depthwise_conv3x3, dwmod.depthwise_conv3x3_backward,
                fused_ir.fused_ir_forward, fused_ir.fused_ir_backward)
    before = [c.launches for c in counters]
    got = _train_grads(model, x, y)
    assert [c.launches - b for c, b in zip(counters, before)] == [17, 17, 33, 33]
    lib = create_model(ModelConfig(dtype="float32", width_mult=0.5,
                                   use_pallas_depthwise=False, fused_ir=False))
    lib.load_state_dict(start)
    lib_grads = _train_grads(lib, x, y)
    model.load_state_dict(start)
    monkeypatch.setattr(dwmod, "depthwise_conv3x3",
                        dwmod.depthwise_conv3x3_reference)
    monkeypatch.setattr(dwmod, "depthwise_conv3x3_backward",
                        lambda x, w, g, s: tuple(
                            t.to(w.dtype) if i else t for i, t in enumerate(
                                dwmod.depthwise_conv3x3_backward_reference(
                                    x, w, g, s))))
    monkeypatch.setattr(fused_ir, "fused_ir_forward",
                        fused_ir.fused_ir_forward_reference)
    monkeypatch.setattr(fused_ir, "fused_ir_backward",
                        fused_ir.fused_ir_backward_reference)
    want = _train_grads(model, x, y)
    ours = list(_grad_errors(got, want).values())
    theirs = list(_grad_errors(lib_grads, want).values())
    assert np.median(ours) <= 2 * np.median(theirs) + 1e-5
    assert max(ours) <= 2 * max(theirs) + 1e-5
