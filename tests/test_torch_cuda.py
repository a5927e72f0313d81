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


# -- flash attention -----------------------------------------------------------

# (b, tq, tk, h, d, causal, segments): the ViT-B/16 shape, causal with
# tq = tk and tq < tk, packed segments with a fully masked row, a T that
# no 64-row tile divides, and each head dim the kernels are built for.
FLASH = [(2, 196, 196, 3, 64, False, False), (1, 130, 130, 2, 32, True, False),
         (2, 40, 130, 2, 128, True, False), (2, 70, 70, 2, 16, False, True),
         (1, 100, 100, 2, 64, True, True)]


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
