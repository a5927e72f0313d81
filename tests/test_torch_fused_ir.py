"""Parity of the port's fused-IR op (1x1 conv + train-mode BN + ReLU6) with
tpunet's Pallas kernel pair.

On the CPU the port's autograd Function runs its plain versions; it is
held against ``jax.vjp`` of ``tpunet.ops.fused_ir.conv1x1_bn_act(...,
interpret=True)`` — the Pallas forward and backward kernels in interpret
mode — as tests/test_fused_ir.py builds it: ``out``, the batch
statistics and all four input gradients, with ReLU6 on and off, odd H/W,
channel counts off a multiple of 8. Tolerances are those of that test:
1e-5 relative to the largest magnitude in float32, 2e-2 in bfloat16.
The card-side kernels are held against the plain versions by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.ops import fused_ir as jfi
from tpunet_torch.ops import fused_ir as pfi

SHAPES = [((2, 8, 8, 16, 24), "float32", 1e-5),
          ((2, 7, 9, 13, 24), "float32", 1e-5),     # odd H/W, off-8 Ci
          ((1, 5, 5, 8, 10), "float32", 1e-5),      # off-8 Co
          ((2, 8, 8, 16, 24), "bfloat16", 2e-2),
          ((2, 7, 7, 24, 16), "bfloat16", 2e-2)]


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6)


def _inputs(shape, seed=0):
    n, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, w, ci)).astype(np.float32),
            (0.1 * rng.standard_normal((ci, co))).astype(np.float32),
            (1.0 + 0.5 * rng.standard_normal(co)).astype(np.float32),
            (0.1 * rng.standard_normal(co)).astype(np.float32),
            np.cos(np.arange(n * h * w * co, dtype=np.float32)
                   ).reshape(n, h, w, co))


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("shape,dtype,tol", SHAPES, ids=str)
def test_function_matches_pallas_pair(shape, dtype, tol, act):
    x, w, scale, bias, ct = _inputs(shape)
    jdt = jnp.dtype(dtype)

    def loss(xx, ww, ss, bb):
        out, mean, var = jfi.conv1x1_bn_act(xx, ww, ss, bb, act, 1e-5,
                                            interpret=True)
        return jnp.sum(out.astype(jnp.float32) * ct), (out, mean, var)

    (_, (out, mean, var)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(scale),
        jnp.asarray(bias))

    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(),
          torch.from_numpy(w).to(tdt).requires_grad_(),
          torch.from_numpy(scale).requires_grad_(),
          torch.from_numpy(bias).requires_grad_()]
    p_out, p_mean, p_var = pfi.conv1x1_bn_act(*ts, act, 1e-5)
    assert p_out.dtype == tdt and p_mean.dtype == torch.float32
    (p_out.float() * torch.from_numpy(ct)).sum().backward()
    names = ("out", "mean", "var", "dx", "dw", "dscale", "dbias")
    got = (p_out.float(), p_mean, p_var) + tuple(t.grad.float() for t in ts)
    want = (out, mean, var) + tuple(grads)
    for name, a, b in zip(names, got, want):
        assert _rel_err(a.detach().numpy(), b) < tol, (name, _rel_err(
            a.detach().numpy(), b))


def test_mean_and_var_carry_no_gradient():
    x, w, scale, bias, _ = _inputs((2, 4, 4, 8, 12))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    out, mean, var = pfi.conv1x1_bn_act(*ts, True, 1e-5)
    assert out.requires_grad
    assert not mean.requires_grad and not var.requires_grad
    assert bool((var >= 0).all())
    assert bool((out >= 0).all()) and bool((out <= 6).all())


def test_plain_wrappers_match_the_reference_composition():
    """fused_ir_forward's sums give the statistics of
    conv1x1_bn_act_reference, and the op equals the reference under
    autograd (float32, the plain path both ways)."""
    x, w, scale, bias, ct = _inputs((2, 5, 7, 13, 10), seed=1)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    ys = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    a = pfi.conv1x1_bn_act(*xs, False, 1e-5)
    b = pfi.conv1x1_bn_act_reference(*ys, False, 1e-5)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-6)
    (a[0] * torch.from_numpy(ct)).sum().backward()
    (b[0] * torch.from_numpy(ct)).sum().backward()
    for u, v in zip(xs, ys):
        torch.testing.assert_close(u.grad, v.grad, rtol=1e-4, atol=1e-5)
    y, s = pfi.fused_ir_forward(torch.from_numpy(x).reshape(-1, 13),
                                torch.from_numpy(w))
    m = y.shape[0]
    torch.testing.assert_close(s[0] / m, b[1].detach(), rtol=1e-5, atol=1e-6)


def test_cpu_calls_launch_no_kernel():
    pfi.fused_ir_forward.launches = 0
    pfi.fused_ir_backward.launches = 0
    x, w, scale, bias, ct = _inputs((1, 4, 4, 8, 8))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    out, _, _ = pfi.conv1x1_bn_act(*ts, True, 1e-5)
    out.sum().backward()
    assert pfi.fused_ir_forward.launches == 0
    assert pfi.fused_ir_backward.launches == 0


@pytest.mark.parametrize("case", ["mixed_dtype", "w_shape", "float16",
                                  "x_not_contiguous", "chan_shape"])
def test_rejects_what_the_kernels_do_not_take(case):
    x, w = torch.zeros(64, 8), torch.zeros(8, 12)
    g = y = torch.zeros(64, 12)
    chan = torch.zeros(6, 12)
    if case == "mixed_dtype":
        w = w.bfloat16()
    elif case == "w_shape":
        w = torch.zeros(6, 12)
    elif case == "float16":
        x, w = x.half(), w.half()
    elif case == "x_not_contiguous":
        x = torch.zeros(8, 64).t()
    elif case == "chan_shape":
        chan = torch.zeros(5, 12)
        with pytest.raises(ValueError):
            pfi.fused_ir_backward(x, g, y, w, chan, True)
        return
    with pytest.raises(ValueError):
        pfi.fused_ir_forward(x, w)
    with pytest.raises(ValueError):
        pfi.fused_ir_backward(x, g, y, w, chan, True)
