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


# (h, w, c, stride): MobileNetV2's 10 depthwise shapes at 224 px, and the
# odd shapes of chip_smoke.py (odd H/W at stride 2; C no multiple of 8,
# the kernel's scalar path).
MNV2_DW = [(112, 112, 32, 1), (112, 112, 96, 2), (56, 56, 144, 1),
           (56, 56, 144, 2), (28, 28, 192, 1), (28, 28, 192, 2),
           (14, 14, 384, 1), (14, 14, 576, 1), (14, 14, 576, 2),
           (7, 7, 960, 1), (15, 17, 144, 2), (28, 28, 100, 1)]


# (n, h, w, c, stride, dtype) of the forward's card checks: every shape of
# MNV2_DW at batch 8 in both dtypes, and the 10 main shapes at the
# training batch in bf16 (the most tiles a block walks).
DW_FWD = ([(8, *s, dt) for s in MNV2_DW
           for dt in (torch.float32, torch.bfloat16)]
          + [(128, *s, torch.bfloat16) for s in MNV2_DW[:10]])


@pytest.mark.parametrize("case", DW_FWD, ids=str)
def test_depthwise_forward_at_mobilenetv2_shapes(cuda, case):
    """The forward's tiles, bands, chunks and persistent blocks at every
    MobileNetV2 shape and the odd ones: equal to the plain version to the
    bit, one launch a call, and a second launch gives the same bits."""
    n, h, w, c, s, dtype = case
    x, wt = _inputs((n, h, w, c, s), 30, dtype)
    before = depthwise_conv3x3.launches
    got = depthwise_conv3x3(x, wt, s)
    assert depthwise_conv3x3.launches == before + 1
    again = depthwise_conv3x3(x, wt, s)
    want = depthwise_conv3x3_reference(x, wt, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def _dw_bwd_inputs(n, h, w, c, s, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    return (torch.randn(n, h, w, c, generator=gen).to("cuda", dtype),
            torch.randn(3, 3, c, generator=gen).to("cuda", dtype),
            torch.randn(n, ho, wo, c, generator=gen).to("cuda", dtype))


def _check_dw_bwd(x, wt, g, s):
    """dx equal to the plain version's to the bit; dw within 1e-5 of the
    sum of its products' magnitudes (plus one bf16 ulp); a second launch
    gives the same bits (no atomics)."""
    before = dwmod.depthwise_conv3x3_backward.launches
    dx, dw = dwmod.depthwise_conv3x3_backward(x, wt, g, s)
    dx2, dw2 = dwmod.depthwise_conv3x3_backward(x, wt, g, s)
    assert dwmod.depthwise_conv3x3_backward.launches == before + 2
    pdx, pdw = dwmod.depthwise_conv3x3_backward_reference(x, wt, g, s)
    _, mag = dwmod.depthwise_conv3x3_backward_reference(x.abs(), wt,
                                                        g.abs(), s)
    torch.cuda.synchronize()
    assert dx.dtype == x.dtype and dw.dtype == wt.dtype
    torch.testing.assert_close(dx, pdx, rtol=0, atol=0)
    tol = 1e-5 * mag + (_bf16_ulp(pdw) if x.dtype == torch.bfloat16 else 0)
    assert bool(((dw.float() - pdw).abs() <= tol).all())
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", MNV2_DW, ids=str)
def test_depthwise_backward_at_mobilenetv2_shapes(cuda, shape, dtype):
    """Every MobileNetV2 shape and the odd ones, batch 2: the kernel's
    tile plan at each (bands, channel chunks, stride-2 parity classes)."""
    x, wt, g = _dw_bwd_inputs(2, *shape, dtype, 20)
    _check_dw_bwd(x, wt, g, shape[-1])


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_backward_unaligned_input_takes_scalar_path(cuda, stride):
    """C % 8 == 0 but x not 16-byte aligned: the scalar path, the same dx
    bits and dw as the plain version."""
    x, wt, g = _dw_bwd_inputs(2, 17, 17, 24, stride, torch.bfloat16, 21)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    _check_dw_bwd(xu, wt, g, stride)


def test_depthwise_backward_is_deterministic_at_the_training_batch(cuda):
    """Batch 128 bf16 at the layer with the most dw partials (112 x 112,
    32 channels: 1,792 of them): two launches, the same dx and dw bits."""
    x, wt, g = _dw_bwd_inputs(128, 112, 112, 32, 1, torch.bfloat16, 22)
    a = dwmod.depthwise_conv3x3_backward(x, wt, g, 1)
    b = dwmod.depthwise_conv3x3_backward(x, wt, g, 1)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


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


# (h, ci, co) of MobileNetV2's 18 distinct fused-IR 1x1 convs at 224 px.
MNV2_FUSED = [(112, 16, 96), (56, 24, 144), (28, 32, 192), (14, 64, 384),
              (14, 96, 576), (7, 160, 960), (112, 32, 16), (56, 96, 24),
              (56, 144, 24), (28, 144, 32), (28, 192, 32), (14, 192, 64),
              (14, 384, 64), (14, 384, 96), (14, 576, 96), (7, 576, 160),
              (7, 960, 160), (7, 960, 320)]
# The tensor-core kernels at MobileNetV2's shapes at batch 8, and FUSED.
TC_FUSED = [(8 * h * h, ci, co) for h, ci, co in MNV2_FUSED] + FUSED


def _fused_grad_inputs(m, co, seed):
    gen = torch.Generator().manual_seed(seed)
    y = (torch.randn(m, co, generator=gen) * 2).to("cuda", torch.bfloat16)
    g = torch.randn(m, co, generator=gen).to("cuda", torch.bfloat16)
    chan = torch.stack([torch.rand(co, generator=gen) + 0.5,
                        torch.randn(co, generator=gen) * 3,
                        torch.rand(co, generator=gen) + 0.5,
                        torch.randn(co, generator=gen),
                        torch.randn(co, generator=gen) * 0.1,
                        torch.randn(co, generator=gen) * 0.1]).cuda()
    return g, y, chan


def _check_fused_bf16(x, w, g, y, chan, act):
    """The bf16 tensor-core forward and backward against their plain
    versions, at the tolerances of the tests above, with one launch each
    counted."""
    f0, b0 = fused_ir.fused_ir_forward.launches, fused_ir.fused_ir_backward.launches
    yk, s = fused_ir.fused_ir_forward(x, w)
    dx, dw = fused_ir.fused_ir_backward(x, g, y, w, chan, act)
    assert fused_ir.fused_ir_forward.launches == f0 + 1
    assert fused_ir.fused_ir_backward.launches == b0 + 1
    py, _ = fused_ir.fused_ir_forward_reference(x, w)
    pdx, pdw = fused_ir.fused_ir_backward_reference(x, g, y, w, chan, act)
    torch.cuda.synchronize()
    tol = 1e-5 * (x.float().abs() @ w.float().abs()) + _bf16_ulp(py.float())
    assert bool(((yk.float() - py.float()).abs() <= tol).all())
    yb = yk.float()
    want = torch.stack([yb.sum(0), (yb * yb).sum(0)])
    smag = torch.stack([yb.abs().sum(0), (yb * yb).sum(0)])
    assert bool(((s - want).abs() <= 1e-5 * smag + 1e-30).all())
    t = fused_ir.grad_conv_out(g, y, chan, act).abs()
    tol = 1e-5 * (t @ w.float().abs().t()) + _bf16_ulp(pdx.float())
    assert bool(((dx.float() - pdx.float()).abs() <= tol).all())
    assert bool(((dw - pdw).abs() <= 1e-5 * (x.float().abs().t() @ t)
                 + 1e-30).all())
    return yk, s, dx, dw


# Batch 512's 112 px rows: 100,352 row tiles, past grid y's 65,535. The
# 112 px expand (one pass, bf16), the 112 px project in float32 (SIMT dx
# over two row ranges) and a bf16 32 -> 192 (two kernels, dx over two
# row ranges).
BIG_M = 512 * 112 * 112


@pytest.mark.parametrize("ci,co,dtype,design", [
    (16, 96, torch.bfloat16, "one_pass"), (32, 16, torch.float32, "simt"),
    (32, 192, torch.bfloat16, "two_kernel")], ids=str)
def test_fused_ir_backward_past_the_grid_row_limit(cuda, ci, co, dtype,
                                                   design):
    """The backward at m = 512 x 112 x 112 against its plain version, at
    the tolerances of test_fused_ir_backward_kernel_vs_plain."""
    plan = fused_ir.backward_plan(BIG_M, ci, co, dtype,
                                  torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
    assert plan.design == design
    x, w = _fused_inputs(BIG_M, ci, co, dtype, 13)
    g, y, chan = _fused_grad_inputs(BIG_M, co, 14)
    g, y = g.to(dtype), y.to(dtype)
    before = fused_ir.fused_ir_backward.launches
    dx, dw = fused_ir.fused_ir_backward(x, g, y, w, chan, True)
    assert fused_ir.fused_ir_backward.launches == before + 1
    pdx, pdw = fused_ir.fused_ir_backward_reference(x, g, y, w, chan, True)
    t = fused_ir.grad_conv_out(g, y, chan, True).abs()
    torch.cuda.synchronize()
    tol = 1e-5 * (t @ w.float().abs().t())
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(pdx.float())
    assert bool(((dx.float() - pdx.float()).abs() <= tol).all())
    assert bool(((dw - pdw).abs() <= 1e-5 * (x.float().abs().t() @ t)
                 + 1e-30).all())


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape", TC_FUSED, ids=str)
def test_fused_ir_tensor_core_kernels_vs_plain(cuda, shape, act):
    """The bf16 forward and backward (tensor cores, each design its plan
    picks) at every MobileNetV2 shape at batch 8 and at FUSED's odd ones,
    ReLU6 on and off, against the plain versions; then a second launch
    on the same inputs gives the same bits (no float atomics)."""
    m, ci, co = shape
    x, w = _fused_inputs(m, ci, co, torch.bfloat16, 11)
    g, y, chan = _fused_grad_inputs(m, co, 12)
    first = _check_fused_bf16(x, w, g, y, chan, act)
    again = fused_ir.fused_ir_forward(x, w) + \
        fused_ir.fused_ir_backward(x, g, y, w, chan, act)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("act", [True, False])
def test_fused_ir_unaligned_view_takes_the_narrow_copy_path(cuda, act):
    """A [1:] row slice of an [M, 13] bf16 tensor starts 26 bytes past a
    16-byte boundary: the kernels load it element by element into the
    same zero-padded tiles, and still agree with the plain versions."""
    m, ci, co = 1000, 13, 24
    xb, w = _fused_inputs(m + 1, ci, co, torch.bfloat16, 13)
    x = xb[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    g, y, chan = _fused_grad_inputs(m, co, 14)
    _check_fused_bf16(x, w, g, y, chan, act)


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


# -- flash attention -----------------------------------------------------------

# (b, tq, tk, h, d, causal, segments): the ViT-B/16 shape, causal with
# tq = tk and tq < tk, packed segments with a fully masked row, a T that
# no 64-row tile divides, and each head dim the kernels are built for.
# Then T that cut through the tensor-core kernels' 16-row warps and
# 8-key / 16-key steps: Tq = Tk of 1, 15, 17 and 65; Tk 9 under Tq 40;
# causal Tq 5 < Tk 70 (the diagonal inside one warp's rows); D 16 and
# 128 at T 196; segments with a row that sees no key at T 33.
FLASH = [(2, 196, 196, 3, 64, False, False), (1, 130, 130, 2, 32, True, False),
         (2, 40, 130, 2, 128, True, False), (2, 70, 70, 2, 16, False, True),
         (1, 100, 100, 2, 64, True, True),
         (2, 1, 1, 2, 64, False, False), (2, 15, 15, 2, 64, False, False),
         (2, 17, 17, 2, 64, True, False), (2, 65, 65, 2, 64, False, False),
         (2, 40, 9, 2, 64, False, False), (2, 5, 70, 2, 64, True, False),
         (1, 196, 196, 2, 16, False, False),
         (1, 196, 196, 2, 128, False, False),
         (2, 33, 33, 2, 32, False, True)]


def _flash_inputs(case, dtype, seed):
    b, tq, tk, h, d, causal, segmented = case
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, tq, h, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=gen) for _ in range(2))
    seg = None
    if segmented:
        qs = torch.randint(1, 4, (b, tq), generator=gen).sort(dim=1).values
        ks = torch.randint(1, 4, (b, tk), generator=gen).sort(dim=1).values
        qs[:, 0] = 9                   # a query whose segment has no key
        seg = (qs.cuda(), ks.cuda())
    return ([t.to("cuda", dtype) for t in (q, k, v, do)], seg, causal)


def _bwd_magnitudes(q, k, v, do, lse, delta, glse, causal, scale, seg):
    """Per output element, the sum of the magnitudes of the products that
    make it (dq, dk, dv), the yardstick of the backward tolerances."""
    from tpunet_torch.ops import flash
    p, _ = flash._p_ds(q, k, v, do, lse, delta, None, causal, scale, seg)
    dpm = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), v.float().abs())
    extra = delta.abs() + (glse.abs() if glse is not None else 0)
    dsm = p * (dpm + extra[..., None]) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", dsm, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", dsm, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()))


def _within(got, want, tol):
    return bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_forward_kernel_vs_plain(cuda, case, dtype):
    """out: float32 sums of p.v in another order, within 1e-5 of max |v|;
    in bf16 plus one ulp of the output and 2^-8 max |v|, for the p that
    the two sides round to bf16 apart. lse within 1e-5 (1 + |lse|), -1e30
    exactly on the rows with no key."""
    from tpunet_torch.ops import flash
    (q, k, v, _), seg, causal = _flash_inputs(case, dtype, 10)
    before = flash.flash_attention_forward.launches
    out, lse = flash.flash_attention_forward(q, k, v, causal=causal,
                                             segment_ids=seg, with_lse=True)
    plain = flash.flash_attention_forward(q, k, v, causal=causal,
                                          segment_ids=seg)
    assert flash.flash_attention_forward.launches == before + 2
    pout, plse = flash.flash_attention_forward_reference(
        q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    torch.testing.assert_close(plain, out, rtol=0, atol=0)
    vmax = v.float().abs().max()
    tol = 1e-5 * vmax
    if dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(pout.float()) + 2.0**-8 * vmax
    assert _within(out, pout, tol)
    assert bool(((lse - plse).abs() <= 1e-5 * (1 + plse.abs())).all())
    dead = plse <= -1e30
    assert bool((lse[dead] == plse[dead]).all())
    assert bool((out.float().transpose(1, 2)[dead] == 0).all())
    if seg is not None:
        assert bool(dead.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("with_glse", [False, True])
@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_backward_kernels_vs_plain(cuda, case, with_glse, dtype):
    """dq, dk, dv: float32 sums of products of p and ds in another order,
    within 1e-5 of the sum of their magnitudes; in bf16 plus one ulp of
    the output and 2^-8 of that sum (p and ds are rounded to bf16 on both
    sides from float32 values that may round apart)."""
    from tpunet_torch.ops import flash
    (q, k, v, do), seg, causal = _flash_inputs(case, dtype, 11)
    out, lse = flash.flash_attention_forward_reference(
        q, k, v, causal=causal, segment_ids=seg)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    glse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(12)
                       ).cuda() if with_glse else None
    kw = dict(causal=causal, segment_ids=seg, glse=glse)
    counts = (flash.flash_attention_dq.launches,
              flash.flash_attention_dkv.launches)
    dq = flash.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    assert (flash.flash_attention_dq.launches,
            flash.flash_attention_dkv.launches) == (counts[0] + 1,
                                                    counts[1] + 1)
    want = (flash.flash_attention_dq_reference(q, k, v, do, lse, delta, **kw),
            *flash.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                                 **kw))
    mags = _bwd_magnitudes(q, k, v, do, lse, delta, glse, causal,
                           q.shape[-1] ** -0.5, seg)
    torch.cuda.synchronize()
    for name, got, ref, mag in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                   mags):
        assert got.dtype == dtype and got.is_contiguous(), name
        tol = 1e-5 * mag
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(ref.float()) + 2.0**-8 * mag
        assert _within(got, ref, tol), (name, (got.float() - ref.float()
                                               ).abs().max().item())


# (b, tq, tk, h, d, causal, segments) of the bf16 tensor-core dQ: T of 1,
# 15, 17, 77 and 196, which cut its 16-row warps and 8- and 16-key steps;
# T 77 at every head dim; causal with tq < tk and the diagonal inside a
# warp; segments with a row that sees no key, alone and causal.
DQ = [(2, 1, 1, 2, 64, False, False), (2, 15, 15, 2, 64, False, False),
      (2, 17, 17, 2, 64, True, False), (2, 77, 77, 2, 16, False, False),
      (2, 77, 77, 2, 32, False, False), (2, 77, 77, 2, 64, False, False),
      (2, 77, 77, 2, 128, False, False), (2, 196, 196, 3, 64, False, False),
      (2, 100, 300, 2, 64, True, False), (2, 5, 70, 2, 64, True, False),
      (2, 100, 100, 2, 32, False, True), (1, 150, 150, 2, 64, True, True)]


@pytest.mark.parametrize("with_glse", [False, True])
@pytest.mark.parametrize("case", DQ, ids=str)
def test_flash_dq_bf16_tensor_core_kernel(cuda, case, with_glse):
    """bf16 dQ on the tensor cores against its plain version (float32 sums
    in another order, within 1e-5 of the sum of the products' magnitudes
    plus one bf16 ulp and 2^-8 of that sum), against the float32 truth
    (the plain version on float32 copies of the inputs: within twice the
    plain bf16 version's error, plus the 1e-5 allowance), and the same
    bits from a second launch."""
    from tpunet_torch.ops import flash
    (q, k, v, do), seg, causal = _flash_inputs(case, torch.bfloat16, 15)
    out, lse = flash.flash_attention_forward_reference(
        q, k, v, causal=causal, segment_ids=seg)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    glse = torch.randn(lse.shape, generator=torch.Generator().manual_seed(16)
                       ).cuda() if with_glse else None
    kw = dict(causal=causal, segment_ids=seg, glse=glse)
    before = flash.flash_attention_dq.launches
    dq = flash.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    again = flash.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    assert flash.flash_attention_dq.launches == before + 2
    want = flash.flash_attention_dq_reference(q, k, v, do, lse, delta, **kw)
    mag = _bwd_magnitudes(q, k, v, do, lse, delta, glse, causal,
                          q.shape[-1] ** -0.5, seg)[0]
    f32 = [t.float() for t in (q, k, v, do)]
    tout, tlse = flash.flash_attention_forward_reference(
        *f32[:3], causal=causal, segment_ids=seg)
    tdelta = (tout * f32[3]).sum(-1).transpose(1, 2).contiguous()
    truth = flash.flash_attention_dq_reference(*f32, tlse, tdelta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq, again)
    tol = 1e-5 * mag + _bf16_ulp(want.float()) + 2.0**-8 * mag
    assert _within(dq, want, tol), (dq.float() - want.float()).abs().max()
    e_k = (dq.float() - truth).abs().max().item()
    e_p = (want.float() - truth).abs().max().item()
    assert e_k <= 2 * e_p + 1e-5 * mag.max().item(), (e_k, e_p)


def test_flash_takes_views_of_a_fused_projection(cuda):
    """q, k, v as qkv[:, :, 0..2] of one [B,T,3,H,D] tensor (strided, no
    copies): the same bits as from contiguous copies, forward and
    backward."""
    from tpunet_torch.ops import flash
    gen = torch.Generator().manual_seed(13)
    qkv = torch.randn(2, 196, 3, 4, 64, generator=gen).cuda().bfloat16()
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, 196, 4, 64, generator=gen).cuda().bfloat16()
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    out, lse = flash.flash_attention_forward(q, k, v, with_lse=True)
    outc, lsec = flash.flash_attention_forward(qc, kc, vc, with_lse=True)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    a = (flash.flash_attention_dq(q, k, v, do, lse, delta),
         *flash.flash_attention_dkv(q, k, v, do, lse, delta))
    b = (flash.flash_attention_dq(qc, kc, vc, do, lse, delta),
         *flash.flash_attention_dkv(qc, kc, vc, do, lse, delta))
    assert torch.equal(out, outc) and torch.equal(lse, lsec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from tpunet_torch.ops import flash
    x = torch.randn(1, 8, 1, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_forward(x[..., :48], x[..., :48], x[..., :48])
    with pytest.raises(ValueError, match="dtypes"):
        flash.flash_attention_forward(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.randn(1, 8, 1, 128, device="cuda")[..., ::2]
        flash.flash_attention_forward(y, y, y)


def test_flash_refuses_an_unaligned_bf16_view(cuda):
    """A bf16 view whose token stride (D + 1 elements) is no multiple of
    16 bytes is refused before any launch: the tensor-core kernels copy
    16-byte chunks."""
    from tpunet_torch.ops import flash
    buf = torch.randn(2, 40, 65, device="cuda").bfloat16()
    bad = buf[..., :64].unsqueeze(2)
    ok = bad.contiguous()
    before = flash.flash_attention_forward.launches
    with pytest.raises(ValueError, match="16 bytes"):
        flash.flash_attention_forward(ok, bad, ok)
    assert flash.flash_attention_forward.launches == before
    flash.flash_attention_forward(ok, ok, ok)
    torch.cuda.synchronize()
    assert flash.flash_attention_forward.launches == before + 1


def test_vit_on_card_launches_the_flash_kernels(cuda):
    """A 2-block bf16 ViT: 2 forward launches in eval (no lse), and one
    train forward/backward launches 2 + 2 + 2; its f32 gradients equal
    those of the plain versions on the card to 1e-4 of the largest."""
    from tpunet_torch.ops import flash
    cfg = ModelConfig(name="vit", vit_patch=4, vit_hidden=128, vit_depth=2,
                      vit_heads=2, dtype="float32", dropout_rate=0.1)
    model = create_model(cfg, image_size=32)
    with torch.no_grad():
        model.classifier.weight.normal_(
            0, 0.5, generator=torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(4, 3, 32, 32, generator=gen).cuda()
    y = torch.randint(0, 10, (4,), generator=gen).cuda()
    counters = (flash.flash_attention_forward, flash.flash_attention_dq,
                flash.flash_attention_dkv)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        model(x)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 0, 0]

    def grads():
        model.zero_grad(set_to_none=True)
        out = model(x, train=True, generator=torch.Generator().manual_seed(1))
        torch.nn.functional.cross_entropy(out, y).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()}

    before = [c.launches for c in counters]
    got = grads()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    from tpunet_torch.ops.attention import dense_attention
    model.attn_fn = dense_attention
    want = grads()
    gmax = max(g.abs().max().item() for g in want.values())
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= 1e-4 * gmax, k


# The LM's shapes (tpunet_torch.models.lm at ViT-B/16's widths): T 1024,
# 12 heads of 64, causal; plain rows, and packed rows whose segment ids
# run 1..k from position 0 with a padding tail of id 0, as q and k/v
# segments of the same row.
LM_FLASH = [(2, 1024, 12, 64, False), (2, 1024, 12, 64, True)]


def _packed(b, t, gen):
    segs = torch.zeros(b, t, dtype=torch.int32)
    for r in range(b):
        lengths = torch.randint(1, 200, (t,), generator=gen).cumsum(0)
        end = t - int(torch.randint(0, t // 8, (1,), generator=gen))
        pos = torch.arange(t)
        segs[r] = torch.where(pos < end, 1 + torch.searchsorted(
            lengths, pos, right=True), 0).to(torch.int32)
    return segs.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", LM_FLASH, ids=["causal", "packed"])
def test_flash_kernels_at_the_lms_shapes(cuda, case, dtype):
    """Forward (out, lse), dQ and dK/dV at the LM's shapes against the
    plain versions, with the tolerances of the tests above."""
    from tpunet_torch.ops import flash
    b, t, h, d, packed = case
    gen = torch.Generator().manual_seed(20)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    seg = None
    if packed:
        s = _packed(b, t, gen)
        seg = (s, s)
    out, lse = flash.flash_attention_forward(q, k, v, causal=True,
                                             segment_ids=seg, with_lse=True)
    pout, plse = flash.flash_attention_forward_reference(
        q, k, v, causal=True, segment_ids=seg)
    vmax = v.float().abs().max()
    bf = dtype == torch.bfloat16
    tol = 1e-5 * vmax + ((_bf16_ulp(pout.float()) + 2.0**-8 * vmax)
                         if bf else 0)
    assert _within(out, pout, tol)
    assert bool(((lse - plse).abs() <= 1e-5 * (1 + plse.abs())).all())
    delta = (pout.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    kw = dict(causal=True, segment_ids=seg)
    got = (flash.flash_attention_dq(q, k, v, do, plse, delta, **kw),
           *flash.flash_attention_dkv(q, k, v, do, plse, delta, **kw))
    want = (flash.flash_attention_dq_reference(q, k, v, do, plse, delta, **kw),
            *flash.flash_attention_dkv_reference(q, k, v, do, plse, delta,
                                                 **kw))
    mags = _bwd_magnitudes(q, k, v, do, plse, delta, None, True,
                           d ** -0.5, seg)
    torch.cuda.synchronize()
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
        tol = 1e-5 * m + ((_bf16_ulp(w.float()) + 2.0**-8 * m) if bf else 0)
        assert _within(g, w, tol), (name, (g.float() - w.float()
                                           ).abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_decode_against_the_flash_forward(cuda, dtype):
    """A tiny LM on the card: the no-cache forward launches the flash
    forward once a layer, a decode step none; teacher-forced decode
    logits against the no-cache forward's at every position (float32:
    1e-4 of the largest logit; bf16: 2^-5 of it, the decode attend's
    float32 p against the kernel's bf16 p), and in float32 the cache and
    no-cache greedy tokens are equal."""
    from tpunet_torch.models.lm import generate
    from tpunet_torch.ops import flash
    cfg = ModelConfig(name="lm", vit_hidden=128, vit_depth=2, vit_heads=2,
                      vocab_size=256, max_seq_len=96, dtype=dtype,
                      dropout_rate=0.0)
    model = create_model(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.embed.weight.normal_(0.0, 0.5, generator=torch.Generator(
            "cuda").manual_seed(4))
    x = torch.randint(0, 256, (2, 80),
                      generator=torch.Generator().manual_seed(5)).cuda()
    fwd = flash.flash_attention_forward
    with torch.inference_mode():
        before = fwd.launches
        full = model(x)
        assert fwd.launches == before + 2
        cache = model.init_cache(2, 80)
        steps = []
        for i in range(80):
            lg, cache = model(x[:, i:i + 1], pos_offset=i, cache=cache)
            steps.append(lg)
        assert fwd.launches == before + 2
    dec = torch.cat(steps, 1)
    scale = full.abs().max().item()
    tol = (1e-4 if dtype == "float32" else 2.0**-5) * scale
    assert (dec - full).abs().max().item() <= tol
    if dtype == "float32":
        prompt = x[:, :8]
        assert torch.equal(generate(model, prompt, 40),
                           generate(model, prompt, 40, use_cache=False))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_serve_engine_greedy_equals_generate(cuda, paged):
    """The float32 serving engine on the card at a small width: 6
    requests through 3 slots (mid-flight admission, slot reuse, the
    paged pool with the prefix cache or the dense pool; a pool cut to
    force a preemption when paged) return generate's greedy tokens, and
    no flash kernel launches (every engine call is a decode step)."""
    from tpunet_torch.config import ServeConfig
    from tpunet_torch.models.lm import generate
    from tpunet_torch.ops import flash
    from tpunet_torch.serve import Engine
    cfg = ModelConfig(name="lm", vit_hidden=128, vit_depth=2, vit_heads=2,
                      vocab_size=256, max_seq_len=96, dtype="float32",
                      dropout_rate=0.0)
    model = create_model(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.embed.weight.normal_(0.0, 0.5, generator=torch.Generator(
            "cuda").manual_seed(4))
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, 16)
    prompts = [np.concatenate([shared, rng.integers(0, 256, k)])
               if i % 2 else rng.integers(0, 256, 4 + k)
               for i, k in enumerate((3, 9, 1, 14, 6, 11))]
    want = [generate(model, torch.tensor(p)[None], 20)[0, len(p):].tolist()
            for p in prompts]
    kw = dict(kv_pages=12, kv_page_tokens=8) if paged else dict(
        paged_kv=False)
    eng = Engine(model, ServeConfig(slots=3, prefill_buckets=(16, 32),
                                    emit_every_s=0.0, **kw)).start()
    before = flash.flash_attention_forward.launches
    try:
        reqs = [eng.submit(p, max_new_tokens=20) for p in prompts]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    assert got == want
    assert flash.flash_attention_forward.launches == before
    snap = eng.registry.snapshot()
    if paged:
        assert snap["serve_prefix_hits_total"] >= 1
        assert snap["serve_kv_preemptions_total"] >= 1


def test_quantize_kv_rows_on_the_card_equals_the_cpu(cuda):
    """The int8 KV quantizer on the card gives the CPU's codes and
    bit-equal scales (a true division, rounding half to even on both),
    for bf16 and float32 rows with an all-zero row, an outlier row and
    exact .5 ties."""
    from tpunet_torch.models.vit import quantize_kv_rows
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(4096, 12, 64, generator=g).to(dtype)
        x[3] = 0
        x[9, 0, 0] = 300.0
        x[11] = 0
        x[11, 0, :32] = torch.arange(-15.5, 16.5)
        x[11, 1, 0] = 127.0
        want_q, want_s = quantize_kv_rows(x)
        got_q, got_s = quantize_kv_rows(x.cuda())
        assert torch.equal(got_q.cpu(), want_q)
        assert torch.equal(got_s.cpu(), want_s)


@pytest.mark.parametrize("wm", [1.0, 0.5])
def test_serve_spec_greedy_equals_spec_off(cuda, wm):
    """Speculative decoding on the card at a small width, float32: with
    self-speculation and a seeded half-width drafter the greedy tokens
    are generate's, the counters balance, and no page leaks."""
    from tpunet_torch.config import ServeConfig
    from tpunet_torch.models.lm import generate
    from tpunet_torch.serve import Engine
    cfg = ModelConfig(name="lm", vit_hidden=128, vit_depth=2, vit_heads=2,
                      vocab_size=256, max_seq_len=96, dtype="float32",
                      dropout_rate=0.0)
    model = create_model(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.embed.weight.normal_(0.0, 0.5, generator=torch.Generator(
            "cuda").manual_seed(4))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 4 + k) for k in (3, 9, 1, 14, 6, 11)]
    want = [generate(model, torch.tensor(p)[None], 20)[0, len(p):].tolist()
            for p in prompts]
    eng = Engine(model, ServeConfig(
        slots=3, prefill_buckets=(16, 32), emit_every_s=0.0, kv_pages=24,
        kv_page_tokens=8, spec_decode=True, spec_k=4,
        spec_draft_width_mult=wm)).start()
    try:
        reqs = [eng.submit(p, max_new_tokens=20) for p in prompts]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        eng.stop()
    assert got == want
    snap = eng.registry.snapshot()
    assert snap["serve_spec_accepted_tokens_total"] \
        + snap["serve_spec_rejected_tokens_total"] \
        == snap["serve_spec_draft_tokens_total"] > 0
    cached = eng._prefix.pages_cached if eng._prefix else 0
    assert len(eng._free_pages) + cached == eng.kv_pages_usable
