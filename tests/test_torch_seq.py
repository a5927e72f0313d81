"""Sequence parallelism of the port (ring and Ulysses attention over the
mesh's 'seq' axis) against tpunet, on the CPU; mirrors
tests/test_attention.py:78-310.

Gangs of gloo ranks (``tests/_torch_shard_worker.py``, one process a
rank) hold seeded q, k, v [2, 32, 4, 16] (numpy), each rank its
positions ``r*T/S`` up (and under 'model' its heads), on three meshes:
'seq' 2 (2 ranks), 'seq' 4 (4 ranks) and 'seq' 2 x 'model' 2 (4 ranks:
SP x TP heads). Each runs ``ring_self_attention`` and
``ulysses_self_attention`` with core ``blockwise`` and ``flash`` (the
flash kernels' plain versions on the CPU), causal and not:

- the output against tpunet's ``ring_self_attention`` /
  ``ulysses_self_attention`` with the same core (flash in interpret
  mode) on the 8-device CPU mesh, its rows and heads of the rank, at
  rtol/atol 2e-5;
- the q/k/v gradients of sum(out^2) over every rank's output (the ring's
  hops and the all-to-alls carry them back) against ``jax.grad`` of
  tpunet's ``dense_attention`` (tpunet's own tests equate the two, and
  the dense gradient compiles in a second where the shard_map's takes
  far longer), at 1e-4;
- the flash ring in bf16, whose merged output stays float32 across the
  folds, against tpunet's float32 dense attention at 0.02 (tpunet's
  test_ring_flash_core_bf16_f32_accumulator bound);
- tpunet's errors, with its messages: an unknown core, 3 heads over a
  'seq' axis of 2, Ulysses on cross-length inputs, and the flash core
  on a causal cross-length ring.

Without a process group the 'seq' axis has one rank: each sequence-
parallel attention is then the local core over the whole sequence,
equal to dense (tpunet's test_ring_single_device_axis). Last, the tiny
ViT (4 heads, tpunet's weights, dropout 0) under ring attention over
'seq' 2: one train-mode forward/backward with the loss split over the
ranks and the gradients summed over 'seq' (the train step's rule)
against tpunet's ``jax.value_and_grad``: the loss to 1e-5 relative, the
logits to 1e-5, every gradient within 1e-5 of the largest.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tpunet.ops import attention as jatt
from tpunet_torch.ops import attention as att
from tpunet_torch.models.convert import vit_state_dict_from_jax

import _torch_gang
import _torch_threads  # noqa: F401
from test_torch_tp import SIZE, jax_vit_params

B, T, H, D = 2, 32, 4, 16
# Ranks and mesh axes of each gang case (tests/_torch_shard_worker.py).
MESHES = {"seq_s2": (2, dict(seq=2, model=1)),
          "seq_s4": (4, dict(seq=4, model=1)),
          "seq_tp": (4, dict(seq=2, model=2))}
VARIANTS = [(attn, core, causal) for attn in ("ring", "ulysses")
            for core in ("blockwise", "flash") for causal in (False, True)]
VARIANT_IDS = [f"{a}-{c}-{'causal' if k else 'full'}"
               for a, c, k in VARIANTS]
FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 0.02


def _qkv():
    rng = np.random.default_rng(20)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _jax_mesh(axes):
    names = ("data", "seq", "model")
    shape = (1, axes["seq"], axes["model"])
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names)


def _jax_fn(attn):
    return {"ring": jatt.ring_self_attention,
            "ulysses": jatt.ulysses_self_attention}[attn]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Both gangs started, tpunet's references computed while they run;
    then every rank's results."""
    d = tmp_path_factory.mktemp("seq")
    q, k, v = _qkv()
    np.savez(d / "seq_qkv.npz", q=q, k=k, v=v)
    jvit, params = jax_vit_params()
    torch.save(vit_state_dict_from_jax(params), d / "vit.pt")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, SIZE, SIZE, 3)).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int64)
    np.savez(d / "images.npz", x=x, y=y)
    gangs = [(2, _torch_gang.start(d, 2, ["seq_s2", "seq_vit_grad"])),
             (4, _torch_gang.start(d, 4, ["seq_s4", "seq_tp"]))]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = {}
    for causal in (False, True):
        ref[("dense", causal)] = np.asarray(jatt.dense_attention(
            jq, jk, jv, causal=causal))

        def loss(q, k, v, causal=causal):
            return jnp.sum(jatt.dense_attention(q, k, v, causal=causal) ** 2)

        ref[("grads", causal)] = [np.asarray(g) for g in jax.jit(jax.grad(
            loss, argnums=(0, 1, 2)))(jq, jk, jv)]
    for name, (_, axes) in MESHES.items():
        mesh = _jax_mesh(axes)
        for attn, core, causal in VARIANTS:
            ref[(name, attn, core, causal)] = np.asarray(_jax_fn(attn)(
                jq, jk, jv, mesh, causal=causal, core=core))
    mesh = _jax_mesh(MESHES["seq_s2"][1])
    with pytest.raises(ValueError) as e:
        jatt.ring_self_attention(jq, jk, jv, mesh, core="blokwise")
    ref["unknown_core"] = str(e.value)
    with pytest.raises(ValueError) as e:
        jatt.ulysses_self_attention(jq[:, :, :3], jk[:, :, :3],
                                    jv[:, :, :3], mesh)
    ref["indivisible_heads"] = str(e.value)

    def vit_loss(p):
        logits = jvit.apply({"params": p}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y, jnp.int32)).mean(), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        vit_loss, has_aux=True))(params)
    ref["vit"] = dict(loss=float(jloss), logits=np.asarray(jlogits),
                      grads=vit_state_dict_from_jax(jax.tree_util.tree_map(
                          np.asarray, jgrads)))
    for world, procs in gangs:
        _torch_gang.wait(d, world, procs)
    got = {}
    for name, (world, _) in MESHES.items():
        got[name] = [torch.load(d / f"{name}_rank{r}.pt")
                     for r in range(world)]
    got["seq_vit_grad"] = [torch.load(d / f"seq_vit_grad_rank{r}.pt")
                           for r in range(2)]
    return dict(ref=ref, got=got)


def _mine(a, rank, axes):
    """Rank ``rank``'s rows and heads of a global [B, T, H, D] array (the
    mesh is row-major over (data, seq, pipe, model))."""
    n, m = axes["seq"], axes["model"]
    r, j = (rank // m) % n, rank % m
    t, h = a.shape[1], a.shape[2]
    return a[:, r * t // n:(r + 1) * t // n, j * h // m:(j + 1) * h // m]


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("name", list(MESHES))
def test_forward_matches_tpunet(gang, name, variant):
    world, axes = MESHES[name]
    want = gang["ref"][(name,) + variant]
    np.testing.assert_allclose(want, gang["ref"][("dense", variant[2])],
                               rtol=FWD_TOL, atol=FWD_TOL)
    for rank, dump in enumerate(gang["got"][name]):
        np.testing.assert_allclose(dump[variant]["out"].numpy(),
                                   _mine(want, rank, axes), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("name", list(MESHES))
def test_gradients_match_tpunet_dense(gang, name, variant):
    world, axes = MESHES[name]
    want = gang["ref"][("grads", variant[2])]
    for rank, dump in enumerate(gang["got"][name]):
        for which, g, w in zip("qkv", dump[variant]["grads"], want):
            np.testing.assert_allclose(g.numpy(), _mine(w, rank, axes),
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"rank {rank} d{which}")


@pytest.mark.parametrize("name", list(MESHES))
def test_bf16_flash_ring_keeps_a_float32_carry(gang, name):
    world, axes = MESHES[name]
    want = gang["ref"][("dense", True)]
    for rank, dump in enumerate(gang["got"][name]):
        np.testing.assert_allclose(dump["bf16_ring"].numpy(),
                                   _mine(want, rank, axes), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("tag,match", [
    ("unknown_core", "unknown attention core 'blokwise'"),
    ("indivisible_heads", "3 heads not divisible by sequence axis 2"),
    ("cross_length", "ulysses_attention is self-attention only"),
    ("flash_causal_cross_length",
     "core='flash' does not support causal cross-length rings")])
def test_errors_are_tpunets(gang, tag, match):
    for dump in gang["got"]["seq_s2"]:
        assert dump["errors"][tag] is not None, tag
        assert match in dump["errors"][tag]
        if tag in gang["ref"]:
            assert dump["errors"][tag] == gang["ref"][tag]


@pytest.mark.parametrize("name", ["ring_attention", "ring_self_attention",
                                  "ulysses_attention",
                                  "ulysses_self_attention"])
@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_seq_axis_is_dense(name, causal):
    """No process group: the 'seq' axis has one rank, and each
    sequence-parallel attention is its local core over the whole
    sequence (tpunet's test_ring_single_device_axis)."""
    q, k, v = _qkv()
    want = np.asarray(jatt.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    fn = functools.partial(getattr(att, name), causal=causal)
    for core in (None, "blockwise"):
        got = fn(*(torch.from_numpy(a) for a in (q, k, v)), core=core)
        np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_seq_vit_forward_backward_matches_tpunet(gang):
    ref = gang["ref"]["vit"]
    gmax = max(float(np.abs(g).max()) for g in ref["grads"].values())
    assert gmax > 1e-2
    for got in gang["got"]["seq_vit_grad"]:
        assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                                   rtol=1e-5, atol=1e-5)
        assert set(got["grads"]) == set(ref["grads"])
        for k, g in got["grads"].items():
            err = float((g - torch.as_tensor(ref["grads"][k])).abs().max())
            assert err <= 1e-5 * gmax, (k, err, gmax)
