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
