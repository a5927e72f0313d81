"""Parity of the port's flash attention with tpunet's, on the CPU.

The same float32 inputs (made with numpy) go through tpunet's Pallas
kernels in interpret mode (``flash_attention(..., interpret=True)`` with
blocks of 16, so that its online softmax runs over several key blocks,
as tests/test_attention.py runs them) and through the port's
``flash_attention``, which on a CPU tensor runs the plain versions of
the three kernels through ``FlashAttentionFunction``:

- outputs, and lse through ``local_flash_attention_state``;
- dq, dk and dv through autograd against ``jax.grad`` of the same
  scalar;
- non-causal, causal with tq = tk, causal with tq < tk (the ``tk - tq``
  offset), packed segments with a query whose segment has no key, and a
  nonzero glse: the gradient through ``merge_attention_states``, where
  the lse of each state is consumed.

Tolerance 1e-5 (relative and absolute): both sides compute in float32
and differ only in the order of the sums (tiles of 16 against the plain
version's whole rows, XLA's dot against torch's). The plain forward also
steps through key tiles; run with tiles of 16 it gives the same results.
The wrappers raise on a dtype, layout or head dim the kernels do not
take, and on the CPU no launch is counted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.ops import flash as jflash
from tpunet_torch.ops import flash
import _torch_threads  # noqa: E402,F401

# (b, tq, tk, h, d, causal, segments)
CASES = [(2, 48, 48, 2, 16, False, False), (2, 48, 48, 2, 16, True, False),
         (1, 32, 80, 2, 16, True, False), (2, 48, 48, 2, 16, False, True),
         (2, 48, 48, 2, 16, True, True)]
IDS = ["plain", "causal", "causal_tq_lt_tk", "segments", "causal_segments"]
BLOCK = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(case, seed=0):
    b, tq, tk, h, d, causal, segmented = case
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, tq, h, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, tk, h, d)).astype(np.float32)
            for _ in range(2))
    seg = None
    if segmented:
        qs = np.sort(rng.integers(1, 4, (b, tq)), axis=1).astype(np.int32)
        ks = np.sort(rng.integers(1, 4, (b, tk)), axis=1).astype(np.int32)
        qs[:, 0] = 9                         # no key of segment 9
        seg = (qs, ks)
    return (q, k, v, g), seg, causal


def _jflash(causal, seg):
    return functools.partial(
        jflash.flash_attention, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True,
        segment_ids=None if seg is None else tuple(map(jnp.asarray, seg)))


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case_results(request):
    """One case through both packages: outputs, lse and the gradients of
    sum(out * g)."""
    (q, k, v, g), seg, causal = _inputs(request.param)
    jf = _jflash(causal, seg)
    jout = np.asarray(jf(*map(jnp.asarray, (q, k, v))))
    jgrads = jax.grad(lambda a, b, c: (jf(a, b, c) * g).sum(),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    if seg is None:
        _, jlse = jflash.local_flash_attention_state(
            *map(jnp.asarray, (q, k, v)), causal=causal, block_q=BLOCK,
            block_k=BLOCK, interpret=True)
    else:                  # the state variant takes no segments
        _, jlse = jflash._forward_impl(
            *map(jnp.asarray, (q, k, v)), causal, q.shape[-1] ** -0.5,
            BLOCK, BLOCK, True, with_lse=True,
            segment_ids=tuple(map(jnp.asarray, seg)))
    tseg = None if seg is None else tuple(map(torch.from_numpy, seg))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash.flash_attention(tq_, tk_, tv_, causal=causal,
                                segment_ids=tseg)
    (out * torch.from_numpy(g)).sum().backward()
    _, lse = flash.flash_attention_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        segment_ids=tseg, with_lse=True)
    return dict(jout=jout, jlse=np.asarray(jlse), jgrads=jgrads,
                out=out.detach().numpy(), lse=lse.numpy(),
                grads=(tq_.grad, tk_.grad, tv_.grad), seg=seg)


def test_outputs_match_tpunet(case_results):
    r = case_results
    np.testing.assert_allclose(r["out"], r["jout"], **TOL)
    if r["seg"] is not None:
        assert np.all(r["out"][:, 0] == 0)   # the orphan query's row


def test_lse_matches_tpunet(case_results):
    r = case_results
    np.testing.assert_allclose(r["lse"], r["jlse"], **TOL)
    if r["seg"] is not None:
        assert np.all(r["lse"][:, :, 0] == -1e30)


@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
def test_gradients_match_jax_grad(case_results, which):
    r = case_results
    i = "dq dk dv".split().index(which)
    np.testing.assert_allclose(r["grads"][i].numpy(),
                               np.asarray(r["jgrads"][i]), **TOL)


def test_glse_through_merged_states_matches_tpunet():
    """Two states over the two halves of the keys, merged: the loss reads
    the merged output and lse, so each state's lse gets a nonzero
    cotangent, which the backward kernels take as glse."""
    (q, k, v, g), _, _ = _inputs(CASES[0], seed=3)
    h = np.random.default_rng(4).standard_normal(
        (q.shape[0], q.shape[2], q.shape[1])).astype(np.float32)
    half = k.shape[1] // 2

    def jloss(q, k, v):
        st = functools.partial(jflash.local_flash_attention_state,
                               block_q=BLOCK, block_k=BLOCK, interpret=True)
        out, lse = jflash.merge_attention_states(
            st(q, k[:, :half], v[:, :half]), st(q, k[:, half:], v[:, half:]))
        return (out * g).sum() + (lse * h).sum()

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash.merge_attention_states(
        flash.local_flash_attention_state(tq_, tk_[:, :half], tv_[:, :half]),
        flash.local_flash_attention_state(tq_, tk_[:, half:], tv_[:, half:]))
    loss = (out * torch.from_numpy(g)).sum() + (lse * torch.from_numpy(h)).sum()
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for got, want in zip((tq_.grad, tk_.grad, tv_.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_merge_of_dead_rows_gives_zeros():
    """A row masked in both states (lse -1e30) merges to 0 and -1e30."""
    (q, k, v, _), _, _ = _inputs(CASES[2], seed=5)
    ta = [torch.from_numpy(a) for a in (q, k, v)]
    sa = flash.local_flash_attention_state(ta[0], ta[1][:, :8], ta[2][:, :8],
                                           causal=True)
    out, lse = flash.merge_attention_states(sa, sa)
    jout, jlse = jflash.merge_attention_states(
        *[(jnp.asarray(sa[0].numpy()), jnp.asarray(sa[1].numpy()))] * 2)
    dead = sa[1] <= -1e30
    assert bool(dead.any())
    assert bool((lse[dead] == -1e30).all())
    assert bool((out.transpose(1, 2)[dead] == 0).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_tiles_give_the_same_result(case):
    """The plain forward over tiles of 16 keys (several online-softmax
    steps) against its default tile of 64 (one step at these lengths)."""
    (q, k, v, _), seg, causal = _inputs(case, seed=6)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tseg = None if seg is None else tuple(map(torch.from_numpy, seg))
    a = flash.flash_attention_forward_reference(*t, causal=causal,
                                                segment_ids=tseg, block_k=16)
    b = flash.flash_attention_forward_reference(*t, causal=causal,
                                                segment_ids=tseg)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def test_no_grad_forward_writes_no_lse_and_equals_the_autograd_one():
    (q, k, v, _), _, _ = _inputs(CASES[1], seed=7)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with torch.no_grad():
        a = flash.flash_attention(*t, causal=True)
    b = flash.flash_attention(*(x.clone().requires_grad_() for x in t),
                              causal=True)
    assert not isinstance(a, tuple)
    torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def test_cpu_calls_count_no_launch():
    counters = (flash.flash_attention_forward, flash.flash_attention_dq,
                flash.flash_attention_dkv)
    before = [c.launches for c in counters]
    (q, k, v, g), _, _ = _inputs(CASES[0], seed=8)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash.flash_attention(*t) * torch.from_numpy(g)).sum().backward()
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("bad,match", [
    (lambda x: (x.double(),) * 3, "dtypes"),
    (lambda x: (x.half(),) * 3, "dtypes"),
    (lambda x: (x, x.bfloat16(), x), "dtypes"),
    (lambda x: (x[..., :8],) * 3, "head dim"),
    (lambda x: (torch.cat([x, x[..., :8]], -1),) * 3, "head dim"),
    (lambda x: (x.transpose(1, 3).contiguous().transpose(1, 3),) * 3,
     "contiguous"),
    (lambda x: (x[0],) * 3, "BTHD"),
    (lambda x: (x, x[:, :5, :1], x[:, :5]), "do not match"),
], ids=["f64", "f16", "mixed", "d8", "d24", "layout", "rank", "shapes"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(bad, match):
    x = torch.randn(2, 6, 2, 16)
    with pytest.raises(ValueError, match=match):
        flash.flash_attention_forward(*bad(x))


def test_backward_wrappers_check_their_row_inputs():
    x = torch.randn(2, 6, 2, 16)
    lse = torch.zeros(2, 2, 6)
    with pytest.raises(ValueError, match="lse/delta/glse"):
        flash.flash_attention_dq(x, x, x, x, lse[:, :1], lse)
    with pytest.raises(ValueError, match="lse/delta/glse"):
        flash.flash_attention_dkv(x, x, x, x, lse, lse.double())
    with pytest.raises(ValueError, match="segment_ids"):
        flash.flash_attention_forward(
            x, x, x, segment_ids=(torch.zeros(2, 6), torch.zeros(2, 6)))
    with pytest.raises(ValueError, match="block_q"):
        flash.flash_attention(x, x, x, block_q=0)



def _token_stride_d_plus_1(x, dtype=torch.bfloat16):
    """x [B,T,1,D] as a view whose token stride is D + 1 elements."""
    b, t, _, d = x.shape
    buf = torch.zeros(b, t, d + 1, dtype=dtype)
    buf[..., :d] = x[:, :, 0]
    return buf[..., :d].unsqueeze(2)


def _pointer_plus_2(x):
    """x as a contiguous bf16 view 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


@pytest.mark.parametrize("make", [_token_stride_d_plus_1, _pointer_plus_2],
                         ids=["token_stride_d_plus_1", "pointer_plus_2"])
def test_unaligned_bf16_operands_raise(make):
    """The bf16 kernels copy 16-byte chunks, so a bf16 operand whose data
    pointer or batch/token/head stride is no multiple of 16 bytes is
    refused on the CPU as on the card, by every wrapper."""
    x = torch.randn(2, 6, 1, 16)
    bad, ok = make(x), x.bfloat16()
    assert bad.stride(-1) == 1 and torch.equal(bad, ok)
    lse = torch.zeros(2, 1, 6)
    with pytest.raises(ValueError, match="16 bytes"):
        flash.flash_attention_forward(ok, bad, ok)
    with pytest.raises(ValueError, match="16 bytes"):
        flash.flash_attention(bad, ok, ok)
    with pytest.raises(ValueError, match="16 bytes"):
        flash.flash_attention_dq(ok, ok, ok, bad, lse, lse)
    with pytest.raises(ValueError, match="16 bytes"):
        flash.flash_attention_dkv(ok, ok, bad, ok, lse, lse)


def test_float32_and_fused_projection_views_pass_the_alignment_rule():
    """float32 operands may have any token stride; the ViT's qkv.unbind(2)
    views of a fused projection pass in bf16. Both give the values of
    contiguous copies."""
    x = torch.randn(2, 6, 1, 16)
    f32 = _token_stride_d_plus_1(x, torch.float32)
    assert f32.stride(1) == 17
    torch.testing.assert_close(flash.flash_attention_forward(f32, f32, f32),
                               flash.flash_attention_forward(x, x, x),
                               rtol=0, atol=0)
    qkv = torch.randn(2, 6, 3, 2, 16).bfloat16()
    q, k, v = qkv.unbind(2)
    out = flash.flash_attention_forward(q, k, v)
    want = flash.flash_attention_forward(*(t.contiguous() for t in (q, k, v)))
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_backward_copies_an_unaligned_output_gradient():
    """An output gradient that is a bf16 view the kernels cannot read
    (token stride D + 1) is copied before the backward, which then gives
    the gradients of its contiguous copy."""
    gen = torch.Generator().manual_seed(9)
    x = [torch.randn(2, 6, 1, 16, generator=gen).bfloat16().requires_grad_()
         for _ in range(3)]
    g = _token_stride_d_plus_1(torch.randn(2, 6, 1, 16, generator=gen))
    assert flash._misaligned(g)
    got = torch.autograd.grad(flash.flash_attention(*x), x, g)
    want = torch.autograd.grad(flash.flash_attention(*x), x, g.contiguous())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
