"""Parity of the port's 3x3 depthwise conv with tpunet's Pallas kernels.

On the CPU the port's wrapper runs its plain version; it is held
against ``tpunet.ops.depthwise_conv3x3(x, w, s, True)`` (the Pallas
kernel in interpret mode, as tests/test_ops.py runs it) and against
tpunet's XLA reference. The hand-written CUDA kernel is held against the
plain version by the ``cuda``-marked tests of tests/test_torch_cuda.py,
which import no JAX so that they run on the card's machine, and skip
here.
Tolerances: 1e-5 in float32 (the two sum the same 9 products in
possibly another order); in bfloat16, 1 bf16 ulp (each side rounds its
own float32 sum once). The backward — the port's autograd Function on
the CPU — is held against ``jax.vjp`` of the Pallas backward in
interpret mode to 2e-4, the tolerance of tests/test_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunet.ops as jops
from tpunet_torch.ops import depthwise_conv3x3, depthwise_conv3x3_reference
from tpunet_torch.ops import depthwise as port_dw
import _torch_threads  # noqa: E402,F401

# (n, h, w, c, stride): strides 1/2, odd H/W, C in {8, 24, 40}, plus a
# C that is no multiple of 8 (the kernel's scalar path).
SHAPES = [
    (2, 8, 8, 8, 1),
    (2, 8, 8, 8, 2),
    (1, 9, 7, 24, 2),
    (2, 7, 9, 24, 1),
    (1, 11, 11, 40, 2),
    (2, 6, 6, 40, 1),
    (1, 5, 5, 12, 2),
]


def _inputs(shape, seed):
    n, h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, c)).astype(np.float32),
            rng.standard_normal((3, 3, c)).astype(np.float32))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret_f32(shape):
    x, w = _inputs(shape, 0)
    stride = shape[-1]
    got = depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w), stride)
    want = np.asarray(jops.depthwise_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                             stride, True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_xla_reference_f32(shape):
    x, w = _inputs(shape, 1)
    stride = shape[-1]
    got = depthwise_conv3x3_reference(torch.from_numpy(x),
                                      torch.from_numpy(w), stride)
    want = np.asarray(jops.depthwise_conv3x3_reference(
        jnp.asarray(x), jnp.asarray(w), stride))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret_bf16(shape):
    x, w = _inputs(shape, 2)
    stride = shape[-1]
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    got = depthwise_conv3x3(xt, wt, stride)
    assert got.dtype == torch.bfloat16
    want = jops.depthwise_conv3x3(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(w, jnp.bfloat16), stride, True)
    got32 = got.float().numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    ulp = _bf16_ulp(np.maximum(np.abs(got32), np.abs(want32)))
    assert np.all(np.abs(got32 - want32) <= ulp)


def test_cpu_call_launches_no_kernel():
    port_dw.depthwise_conv3x3.launches = 0
    x, w = _inputs((1, 8, 8, 8, 1), 3)
    depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w), 1)
    assert depthwise_conv3x3.launches == 0


def test_channels_last_nchw_is_accepted_as_nhwc():
    x, w = _inputs((2, 8, 8, 16, 1), 4)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    got = depthwise_conv3x3(nchw.permute(0, 2, 3, 1), torch.from_numpy(w), 1)
    want = depthwise_conv3x3_reference(torch.from_numpy(x),
                                       torch.from_numpy(w), 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", [
    "stride3", "float16", "mixed_dtype", "w_shape", "not_contiguous",
    "rank3", "empty", "meta_device"])
def test_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8)
    stride = 1
    if case == "stride3":
        stride = 3
    elif case == "float16":
        x, w = x.half(), w.half()
    elif case == "mixed_dtype":
        w = w.bfloat16()
    elif case == "w_shape":
        w = torch.zeros(3, 3, 4)
    elif case == "not_contiguous":
        x = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)
    elif case == "rank3":
        x = x[0]
    elif case == "empty":
        x = torch.zeros(0, 4, 4, 8)
    elif case == "meta_device":
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        depthwise_conv3x3(x, w, stride)


# The odd grid of tests/test_ops.py's backward test: odd H/W, non-square,
# channel counts off a multiple of 8, tiny and stride 2.
BWD_GRID = [(8, 8, 16, 1), (8, 8, 16, 2), (7, 7, 24, 1), (7, 7, 24, 2),
            (7, 9, 40, 1), (9, 7, 40, 2), (5, 5, 8, 2), (4, 6, 3, 2)]


def _bwd_inputs(h, w, c, stride, seed):
    rng = np.random.default_rng(seed)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    return (rng.standard_normal((2, h, w, c)).astype(np.float32),
            rng.standard_normal((3, 3, c)).astype(np.float32),
            rng.standard_normal((2, ho, wo, c)).astype(np.float32))


@pytest.mark.parametrize("h,w,c,stride", BWD_GRID, ids=str)
def test_autograd_function_matches_pallas_backward(h, w, c, stride):
    x, wt, g = _bwd_inputs(h, w, c, stride, h * 31 + stride)
    _, vjp = jax.vjp(lambda xx, ww: jops.depthwise_conv3x3(xx, ww, stride,
                                                           True),
                     jnp.asarray(x), jnp.asarray(wt))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    y = port_dw.depthwise_conv3x3_train(xt, wtt, stride)
    y.backward(torch.from_numpy(g))
    assert xt.grad.is_contiguous()      # NHWC, as the kernel writes dx
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(wtt.grad.numpy(), np.asarray(want_dw),
                               rtol=2e-4, atol=2e-4)


def test_backward_bf16_returns_input_dtypes_and_launches_nothing():
    x, wt, g = _bwd_inputs(8, 8, 32, 2, 0)
    port_dw.depthwise_conv3x3_backward.launches = 0
    xb, wb, gb = (torch.from_numpy(a).bfloat16() for a in (x, wt, g))
    dx, dw = port_dw.depthwise_conv3x3_backward(xb, wb, gb, 2)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    assert port_dw.depthwise_conv3x3_backward.launches == 0
    # dw is summed in float32 and then rounded: within one bf16 ulp of
    # the float32 sum of the same bf16 inputs.
    _, dw32 = port_dw.depthwise_conv3x3_backward_reference(
        xb.float(), wb.float(), gb.float(), 2)
    assert np.all(np.abs(dw.float().numpy() - dw32.numpy())
                  <= _bf16_ulp(dw32.numpy()))


@pytest.mark.parametrize("case", ["g_shape", "g_dtype", "g_not_contiguous"])
def test_backward_rejects_a_bad_gradient(case):
    x, w = torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 8)
    g = torch.zeros(1, 4, 4, 8)
    if case == "g_shape":
        g = torch.zeros(1, 8, 8, 8)
    elif case == "g_dtype":
        g = g.bfloat16()
    elif case == "g_not_contiguous":
        g = torch.zeros(1, 8, 4, 4).permute(0, 2, 3, 1)
    with pytest.raises(ValueError):
        port_dw.depthwise_conv3x3_backward(x, w, g, 2)


# (n, h, w, c, stride) the backward kernel's tile plan is held to: the 10
# MobileNetV2 depthwise shapes at the training batch, the odd shapes of
# chip_smoke.py (odd H/W at stride 2, C no multiple of 8) and BWD_GRID.
PLAN_SHAPES = ([(128, h, h, c, s) for h, c, s in (
    (112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1),
    (28, 192, 2), (14, 384, 1), (14, 576, 1), (14, 576, 2), (7, 960, 1))]
    + [(8, 15, 17, 144, 2), (8, 28, 28, 100, 1)]
    + [(2, h, w, c, s) for h, w, c, s in BWD_GRID])


def _kernel_columns(wd, chunk, stride):
    """The column of each (column, channel pair) item of a band row, in
    item order, as csrc/depthwise.cu's backward maps them: the pair is the
    fastest index; at stride 2 the even columns come first, then the odd
    ones."""
    order = range(wd) if stride == 1 else [*range(0, wd, 2),
                                           *range(1, wd, 2)]
    return [q for q in order for _ in range(chunk // 2)]


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_backward_plan_covers_every_pixel_and_channel_once(shape, elem):
    """The bands cover every input row once, the chunks every channel
    once, and a band row's items every (column, channel pair) once, with
    each thread on one pair throughout; the staged gradient rows hold
    every tap the band reaches; the tile fits 48 KB; and the dw partials
    number one per image and band of at least 4 rows (or the whole
    image), not one per pixel."""
    n, h, w, c, s = shape
    plan = port_dw.backward_plan(n, h, w, c, s, elem)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    rows = np.zeros(h, int)
    for b in range(plan.bands):
        rows[b * plan.rows:(b + 1) * plan.rows] += 1
    assert (rows == 1).all() and (plan.bands - 1) * plan.rows < h
    chans = np.zeros(plan.chunks * plan.chunk, int)
    for k in range(plan.chunks):
        chans[k * plan.chunk:(k + 1) * plan.chunk] += 1
    assert (chans[:c] == 1).all() and (plan.chunks - 1) * plan.chunk < c
    assert plan.chunk in (8, 16, 32, 64) and (c % 8 or c % plan.chunk == 0)
    pairs = plan.chunk // 2
    cols = _kernel_columns(w, plan.chunk, s)
    items = {(q, i % pairs) for i, q in enumerate(cols)}
    assert len(cols) == w * pairs and items == {
        (q, k) for q in range(w) for k in range(pairs)}
    assert plan.threads % 32 == 0 and plan.threads % pairs == 0
    assert 32 <= plan.threads <= 128
    if s == 2:
        assert plan.rows % 2 == 0
        # Even columns first: a warp's lanes share the column's parity
        # but in at most one warp.
        parity = np.array(cols) % 2
        assert (np.diff(parity) >= 0).all()
    for b in range(plan.bands):
        p0 = b * plan.rows
        gi0 = p0 - 1 if s == 1 else p0 // 2
        for p in range(p0, min(h, p0 + plan.rows)):
            for dy in range(3):
                if (p + 1 - dy) % s == 0 and 0 <= (p + 1 - dy) // s < ho:
                    assert 0 <= (p + 1 - dy) // s - gi0 < plan.grad_rows
    assert plan.stage_bytes == (plan.grad_rows * (wo + 2)
                                + plan.rows * w) * plan.chunk * elem
    assert plan.stage_bytes <= 48 * 1024
    assert min(h, 4) <= plan.rows <= 16
    assert plan.partials == n * plan.bands <= n * -(-h // min(h, 4))


def test_backward_plan_keeps_the_widest_chunk_that_fits():
    """MobileNetV2's first block at batch 128 (112 x 112, 32 channels,
    bf16): 4 rows of x and 6 of the gradient, 112 and 114 pixels wide,
    take 72 KB at 32 channels and 36 KB at 16, which then fits 5 rows
    (23 bands, the last of 2 rows); the 7 x 7 x 960 layer takes 64
    channels and its whole image in one band; a 14-row image is cut into
    two bands of 7."""
    first = port_dw.backward_plan(128, 112, 112, 32, 1, 2)
    assert (first.chunk, first.rows, first.bands, first.threads) == (
        16, 5, 23, 128)
    last = port_dw.backward_plan(128, 7, 7, 960, 1, 2)
    assert (last.chunk, last.rows, last.bands, last.threads) == (
        64, 7, 1, 128)
    mid = port_dw.backward_plan(128, 14, 14, 384, 1, 2)
    assert (mid.chunk, mid.rows, mid.bands) == (64, 7, 2)


# (n, h, w, c, stride) the forward kernel's plan is held to: the 10
# MobileNetV2 depthwise shapes at the serving and the training batch, the
# odd shapes of chip_smoke.py, SHAPES and BWD_GRID.
_MNV2_DW = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2),
            (28, 192, 1), (28, 192, 2), (14, 384, 1), (14, 576, 1),
            (14, 576, 2), (7, 960, 1)]
FWD_PLAN_SHAPES = ([(n, h, h, c, s) for n in (8, 128) for h, c, s in _MNV2_DW]
                   + [(8, 15, 17, 144, 2), (8, 28, 28, 100, 1)] + SHAPES
                   + [(2, h, w, c, s) for h, w, c, s in BWD_GRID])
H100_SMS = 132


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", FWD_PLAN_SHAPES, ids=str)
def test_forward_plan_covers_every_output_and_channel_once(shape, elem):
    """The bands cover every output row once and the chunks every channel
    once; the threads, as csrc/depthwise.cu maps them (channel pair the
    fastest index, two neighbouring columns a thread), every (column,
    channel pair) of a band row once, each thread on one pair; a tile's
    staged rows and columns hold every tap its outputs reach; two tiles
    fit the shared memory a block may take at its blocks an SM (72 KB at
    three, 110 KB at two); and the persistent blocks walk every tile once,
    each block on one chunk, within the launch limits."""
    n, h, w, c, s = shape
    plan = port_dw.forward_plan(n, h, w, c, s, elem, H100_SMS)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    rows = np.zeros(ho, int)
    for b in range(plan.bands):
        rows[b * plan.rows:(b + 1) * plan.rows] += 1
    assert (rows == 1).all() and (plan.bands - 1) * plan.rows < ho
    assert 1 <= plan.rows <= 16
    chans = np.zeros(plan.chunks * plan.chunk, int)
    for k in range(plan.chunks):
        chans[k * plan.chunk:(k + 1) * plan.chunk] += 1
    assert (chans[:c] == 1).all() and (plan.chunks - 1) * plan.chunk < c
    assert plan.chunk % 8 == 0 and plan.chunk * elem <= 128
    assert c % 8 or c % plan.chunk == 0
    pairs, col_pairs = plan.chunk // 2, -(-wo // 2)
    assert plan.threads % 32 == 0 and plan.threads % pairs == 0
    assert 32 <= plan.threads <= 256
    seen = np.zeros((wo, pairs), int)
    for t in range(plan.threads):
        for j in range(t // pairs, col_pairs, plan.threads // pairs):
            for q in (2 * j, 2 * j + 1):
                if q < wo:
                    seen[q, t % pairs] += 1
    assert (seen == 1).all()
    # Staged rows o0 * s - 1 .., columns -1 .. (staged column i holds
    # image column i - 1); a thread's columns 2j, 2j + 1 reach staged
    # columns s * 2j .. s * (2j + 1) + 2.
    for b in range(plan.bands):
        r0 = b * plan.rows * s - 1
        for o in range(b * plan.rows, min(ho, (b + 1) * plan.rows)):
            for dy in range(3):
                assert 0 <= o * s - 1 + dy - r0 < plan.in_rows
    assert s * (2 * col_pairs - 1) + 2 < plan.in_cols
    assert plan.in_cols >= w + 2 - (s == 2 and w % 2 == 0)
    tile = plan.in_rows * plan.in_cols * plan.chunk * elem
    assert plan.stage_bytes == 2 * -(-tile // 128) * 128
    assert plan.stage_bytes <= {3: 72, 2: 110}[plan.per_sm] * 1024
    assert plan.tiles == n * plan.bands * plan.chunks < 2**31
    assert plan.blocks % plan.chunks == 0 and plan.blocks <= plan.tiles
    assert plan.blocks <= max(plan.per_sm * H100_SMS, plan.chunks)
    walked = np.zeros(plan.tiles, int)
    for blk in range(plan.blocks):
        mine = np.arange(blk, plan.tiles, plan.blocks)
        assert (mine % plan.chunks == blk % plan.chunks).all()
        walked[mine] += 1
    assert (walked == 1).all()


def test_forward_plan_at_the_training_shapes():
    """The plans that the chip's sweep of chunks, bands and blocks chose
    at batch 128 in bf16 (scripts/torch_depthwise_sweep.py): whole 64- or
    96-byte pieces of a pixel where C allows (32 channels at 112 px, 48
    of 144 at 56 px), two blocks an SM where three would cut the band
    below 7 rows, and the 7 x 7 x 960 layer's whole image in one tile of
    64 channels, three blocks an SM."""
    first = port_dw.forward_plan(128, 112, 112, 32, 1, 2, H100_SMS)
    assert (first.chunk, first.rows, first.threads, first.per_sm,
            first.blocks) == (32, 5, 256, 2, 264)
    wide = port_dw.forward_plan(128, 56, 56, 144, 1, 2, H100_SMS)
    assert (wide.chunk, wide.rows, wide.threads, wide.per_sm) == (
        48, 8, 192, 2)
    down = port_dw.forward_plan(128, 112, 112, 96, 2, 2, H100_SMS)
    assert (down.chunk, down.rows, down.in_rows) == (48, 2, 5)
    last = port_dw.forward_plan(128, 7, 7, 960, 1, 2, H100_SMS)
    assert (last.chunk, last.rows, last.bands, last.threads, last.per_sm,
            last.blocks) == (64, 7, 1, 128, 3, 390)
