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


# ---------------------------------------------------------------------------
# The kernels' tile plans (csrc/fused_ir.cu), checked here without a card
# ---------------------------------------------------------------------------

# (h, ci, co) of MobileNetV2's 18 distinct fused-IR 1x1 convs at 224 px
# (chip_smoke.py's EXPAND_SHAPES and PROJECT_SHAPES).
MNV2_FUSED = [(112, 16, 96), (56, 24, 144), (28, 32, 192), (14, 64, 384),
              (14, 96, 576), (7, 160, 960), (112, 32, 16), (56, 96, 24),
              (56, 144, 24), (28, 144, 32), (28, 192, 32), (14, 192, 64),
              (14, 384, 64), (14, 384, 96), (14, 576, 96), (7, 576, 160),
              (7, 960, 160), (7, 960, 320)]
PLAN_SHAPES = ([(b * h * h, ci, co) for b in (8, 128)
                for h, ci, co in MNV2_FUSED]
               + [(1000, 13, 24), (777, 96, 10), (63, 13, 24), (25, 8, 10),
                  (1, 16, 16), (128, 16, 24), (1000, 144, 24)]
               # Batch 512's 112 px layers: 100,352 row tiles, past grid
               # y's 65,535.
               + [(512 * 112 * 112, ci, co)
                  for h, ci, co in MNV2_FUSED if h == 112])
SMS = 132   # the H100's SMs


def _cover(n, starts, width):
    """How often each of n positions lies in one of [s, s + width)."""
    count = np.zeros(n, np.int64)
    for s in starts:
        count[s:s + width] += 1
    return count


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_forward_plan_covers_y_once(shape, dtype):
    m, ci, co = shape
    p = pfi.forward_plan(m, ci, co, dtype, SMS)
    tiles = -(-m // p.tile_rows)
    assert 1 <= p.blocks <= min(tiles, 65535) and p.partials == p.blocks
    # Rows: block b walks the tiles b, b + blocks, ...
    rows = _cover(m, [t * p.tile_rows for b in range(p.blocks)
                      for t in range(b, tiles, p.blocks)], p.tile_rows)
    assert (rows == 1).all()
    cols = _cover(co, [s * p.strip for s in range(p.strips)], p.strip)
    assert (cols == 1).all() and (p.strips - 1) * p.strip < co
    assert p.scratch_bytes == p.partials * 2 * co * 4
    if dtype == torch.bfloat16:
        cip = -(-ci // 16) * 16
        assert p.design == "mma" and p.strip % 8 == 0 and p.strip <= 96
        assert cip % p.k_chunk == 0 and p.k_chunk % 16 == 0
        assert p.smem_bytes == pfi.forward_smem(ci, p.strip, p.k_chunk)
        assert p.smem_bytes <= pfi._MAX_SMEM
        # The strips are whole n8 blocks: at Co = 16, 24 or 32 a block
        # computes no padding column.
        if co % 8 == 0 and co <= 96:
            assert p.strips == 1 and p.strip == co
    else:
        assert (p.design, p.strip, p.k_chunk, p.smem_bytes) == \
            ("simt", 64, 16, 0)


def _one_pass_slots(cip, cop):
    """(warp, slot) -> dw tile index as csrc/fused_ir.cu fills its table:
    slot i of warp v holds tile min(4i + v, last) and stores it only when
    4i + v is a tile."""
    ntiles = (cip // 16) * (cop // 8)
    nt = -(-ntiles // 4)
    return [(v, i, min(4 * i + v, ntiles - 1), 4 * i + v < ntiles)
            for v in range(4) for i in range(nt)], ntiles, nt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_backward_plan_covers_dx_and_dw_once(shape, dtype):
    m, ci, co = shape
    p = pfi.backward_plan(m, ci, co, dtype, SMS)
    elem = 2 if dtype == torch.bfloat16 else 4
    tiles = -(-m // p.tile_rows)
    cip, cop = -(-ci // 16) * 16, -(-co // 16) * 16
    # The scratch of the dw partials stays under its cap, a quarter of the
    # bytes of x and g (one partial at least).
    assert p.scratch_bytes == p.partials * ci * co * 4
    assert p.partials == 1 or \
        p.scratch_bytes <= m * (ci + co) * elem // 4
    assert 1 <= p.partials <= 65535
    if p.design == "one_pass":
        # Persistent blocks over any number of tiles: dx in one launch.
        assert p.dx_rows == m
        assert p.blocks == p.partials <= tiles and p.span == p.tile_rows
        rows = _cover(m, [t * p.tile_rows for b in range(p.blocks)
                          for t in range(b, tiles, p.blocks)], p.tile_rows)
        assert (rows == 1).all()
        assert p.strip == cip >= ci          # dx: all of Ci a tile
        slots, ntiles, nt = _one_pass_slots(cip, cop)
        assert nt <= 12                      # 12 m16 x n8 tiles a warp
        stored = sorted(t for _, _, t, keep in slots if keep)
        assert stored == list(range(ntiles))
        dw = np.zeros((cip, cop), np.int64)  # every partial covers dw
        for t in stored:
            mi, nj = divmod(t, cop // 8)
            dw[mi * 16:mi * 16 + 16, nj * 8:nj * 8 + 8] += 1
        assert (dw == 1).all()
        assert p.smem_bytes == pfi.one_pass_smem(ci, co) <= pfi._MAX_SMEM
        assert p.t_rows == p.t_bytes == 0
    else:
        # dx: every row tile by every strip of 64 Ci columns, launched
        # over row ranges of at most 65535 tiles (grid y).
        assert p.dx_rows % p.tile_rows == 0
        assert 1 <= p.dx_rows // p.tile_rows <= 65535
        launches = _cover(m, range(0, m, p.dx_rows), p.dx_rows)
        assert (launches == 1).all()
        assert p.strip == 64 and p.smem_bytes == 0
        cols = _cover(ci, range(0, ci, p.strip), p.strip)
        assert (cols == 1).all()
        # dw: 64x64 (Ci, Co) tiles, each over p spans of rows.
        dw_tiles = -(-ci // 64) * -(-co // 64)
        assert p.blocks == dw_tiles * p.partials
        step = 32 if dtype == torch.bfloat16 else 16
        assert p.span % step == 0
        spans = _cover(m, range(0, m, p.span), p.span)
        assert (spans == 1).all() and p.partials == -(-m // p.span)
        if p.design == "t_first":
            assert p.t_bytes == 2 * m * co * 2 and 1 <= p.t_rows <= m
        else:
            assert p.t_rows == p.t_bytes == 0


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_one_pass_is_chosen_exactly_where_its_dw_fits(shape):
    """bf16 takes the one-pass kernel exactly where its dw accumulator fits
    a block (48 m16 x n8 tiles) and two blocks an SM fit; float32 never."""
    m, ci, co = shape
    cip, cop = -(-ci // 16) * 16, -(-co // 16) * 16
    fits = (cip // 16) * (cop // 8) <= 48 and \
        pfi._per_sm(pfi.one_pass_smem(ci, co)) >= 2
    got = pfi.backward_plan(m, ci, co, torch.bfloat16, SMS).design
    assert (got == "one_pass") == fits
    if not fits:
        assert got == ("two_kernel" if -(-ci // 64) <= 2 else "t_first")
    assert pfi.backward_plan(m, ci, co, torch.float32, SMS).design == "simt"


def test_mobilenetv2_designs():
    """At batch 128 the 112, 56 and 28 px layers take the one-pass kernel
    but the 28 px expand (32 -> 192, one block an SM), and the 14 and 7 px
    layers the two wide kernels."""
    designs = {(h, ci, co): pfi.backward_plan(128 * h * h, ci, co,
                                              torch.bfloat16, SMS).design
               for h, ci, co in MNV2_FUSED}
    for (h, ci, co), d in designs.items():
        if h >= 28 and (ci, co) != (32, 192):
            assert d == "one_pass", (h, ci, co, d)
        else:
            assert d in ("two_kernel", "t_first"), (h, ci, co, d)
