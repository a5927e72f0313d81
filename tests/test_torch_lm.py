"""Parity of the port's LM (``tpunet_torch.models.lm``) with tpunet's, on
the CPU.

A tiny float32 LM (vocab 64, hidden 32, depth 2, 2 heads of 16, 80
positions): tpunet's init with the LayerNorms, biases and token table
redrawn from numpy (``_torch_port.lm_params``), carried across with
``lm_state_dict_from_jax``. Then

- logits, causal, and with packed ``segment_ids``, against tpunet's LM
  with its dense core and with its flash kernel in interpret mode
  (blocks of 16 over 64 tokens), the port with ``attention`` dense and
  flash (the flash kernels' plain versions here): 1e-5;
- the token datasets bit-equal to tpunet's;
- ``filter_logits`` masks equal to tpunet's on logits with ties;
- greedy ``generate`` tokens, cache and no-cache, equal to tpunet's, and
  a sampled stream repeated by its seed;
- the decode step's logits against the full forward's;
- the ``generate`` CLI against tpunet's on the same weights.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpunet.data import lm as jax_data
from tpunet.infer import generate as jax_gen_cli
from tpunet.models import num_params as jax_num_params
from tpunet.models.lm import filter_logits as jax_filter_logits
from tpunet.models.lm import generate as jax_generate
from tpunet_torch.config import DataConfig, ModelConfig
from tpunet_torch.data import lm as port_data
from tpunet_torch.infer import generate as gen_cli
from tpunet_torch.models import create_model, num_params
from tpunet_torch.models.convert import (lm_params_to_jax,
                                         lm_state_dict_from_jax,
                                         load_state_dict)
from tpunet_torch.models.lm import filter_logits, generate
from tpunet_torch.models.vit import PagedKV

from _torch_port import LM, jax_lm, lm_params, packed_segments, port_lm
import _torch_threads  # noqa: E402,F401

T = 64


@pytest.fixture(scope="module")
def params():
    return lm_params(0)


def _tokens(b, t, seed, vocab=LM["vocab_size"]):
    return np.random.default_rng(seed).integers(0, vocab, (b, t),
                                                dtype=np.int32)


def test_weights_carry_across(params):
    sd = lm_state_dict_from_jax(params)
    model = create_model(ModelConfig(**LM), device="cpu")
    assert set(sd) == set(model.state_dict())
    load_state_dict(model, sd)
    assert num_params(model) == jax_num_params(params)
    np.testing.assert_array_equal(model.embed.weight.detach().numpy(),
                                  params["embed"]["embedding"])
    np.testing.assert_array_equal(
        model.blocks[1].attn.qkv.weight.detach().numpy(),
        params["block01"]["attn"]["qkv"]["kernel"].T)
    # lm_pp's stacked tree of the same weights (ROADMAP Queue A item 8d)
    # reads back as the same state dict.
    stacked = lm_params_to_jax(sd, stacked=True)
    assert stacked["blocks_qkv_k"].shape[0] == len(model.blocks)
    back = lm_state_dict_from_jax(stacked)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("packed", [False, True], ids=["causal", "segments"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_logits_match_tpunet(params, attention, packed):
    x = _tokens(2, T, 1)
    kw = {}
    if packed:
        segs = packed_segments(np.random.default_rng(2), 2, T)
        kw = {"segment_ids": segs}
    want = np.asarray(jax_lm(attention).apply(
        {"params": params}, jnp.asarray(x), train=False,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    port = port_lm(params, attention)
    with torch.no_grad():
        got = port(torch.from_numpy(x), **{k: torch.from_numpy(v)
                                           for k, v in kw.items()}).numpy()
    assert got.dtype == np.float32 and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_positions_offset_and_refusals(params):
    port = port_lm(params)
    x = torch.from_numpy(_tokens(1, 8, 3))
    with torch.no_grad():
        full = port(torch.cat([x, x], 1))
        with pytest.raises(ValueError, match="outside the table"):
            port(x, pos_offset=LM["max_seq_len"] - 4)
        # Per-row positions and active gates are ported (the serving
        # engine's hooks, tests/test_torch_serve_attend.py), and so are
        # int8 KV pages: the prompt through an int8 pool gives the
        # forward's logits within int8's error (codes of 1/127 of each
        # row's absmax), in the pool its codes and their scales.
        int8 = PagedKV(pages=3, page_tokens=8, dtype="int8")
        table = torch.tensor([[1, 2]], dtype=torch.int32)
        for active in (None, torch.ones(1, dtype=torch.bool)):
            pool = port.init_paged_cache(int8)
            got, _ = port(x, pos_offset=torch.zeros(1, dtype=torch.long),
                          cache=pool, decode_active=active, paged_kv=int8,
                          page_table=table)
            err = (got - full[:, :8]).abs().max().item()
            assert 0 < err < 0.02 * full.abs().max().item(), err
            assert pool.k[0].dtype == torch.int8
            assert pool.k[0][8:16].abs().amax((1, 2)).eq(127).all()
            assert (pool.sk[0][8:16] > 0).all() and (pool.sk[0][16:] == 0).all()
        with pytest.raises(ValueError, match="need per-row pos_offset"):
            port(x, decode_active=torch.ones(1, dtype=torch.bool))
        with pytest.raises(ValueError, match="needs a cache"):
            port(x, pos_offset=torch.zeros(1, dtype=torch.long))
        # return_hidden (the vocab-parallel CE's hook) is ported: the
        # final LayerNorm's output, whose tied head gives the logits; a
        # decode step returns logits only.
        h = port(x, return_hidden=True)
        assert h.dtype == torch.float32 and h.shape == (1, 8, LM["vit_hidden"])
        np.testing.assert_allclose((h @ port.embed.weight.t()).numpy(),
                                   port(x).numpy(), rtol=1e-6, atol=1e-6)
        with pytest.raises(ValueError, match="return_hidden"):
            port(x, cache=port.init_cache(1, 16), return_hidden=True)
    want = np.asarray(jax_lm().apply({"params": params}, jnp.asarray(
        x.numpy()), train=False, pos_offset=5))
    with torch.no_grad():
        got = port(x, pos_offset=5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert full.shape == (1, 16, LM["vocab_size"])


def test_decode_steps_match_the_full_forward(params):
    """One token a call through the cache gives the full causal
    forward's logits at every position."""
    port = port_lm(params)
    x = torch.from_numpy(_tokens(2, 24, 4))
    with torch.no_grad():
        full = port(x)
        cache = port.init_cache(2, 24)
        steps = []
        for i in range(24):
            lg, cache = port(x[:, i:i + 1], pos_offset=i, cache=cache)
            steps.append(lg)
    assert cache.index == 24
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="past the cache"):
        port(x[:, :1], pos_offset=0, cache=cache)


# -- data ----------------------------------------------------------------


def test_synthetic_lm_is_bit_equal_to_tpunets():
    for got, want in zip(port_data.synthetic_lm(6, 3, seq_len=20, vocab=37,
                                                seed=4),
                         jax_data.synthetic_lm(6, 3, seq_len=20, vocab=37,
                                               seed=4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _corpus(tmp_path):
    rng = np.random.default_rng(5)
    lines = [bytes(rng.integers(32, 127, int(rng.integers(0, 90)),
                                dtype=np.uint8)).decode() for _ in range(60)]
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("packed", [False, True], ids=["text_lm", "packed"])
def test_text_lm_is_bit_equal_to_tpunets(tmp_path, packed):
    from tpunet.config import DataConfig as JaxDataConfig

    path = _corpus(tmp_path)
    kw = dict(dataset="text_lm", text_path=path, seq_len=64,
              pack_docs=packed)
    got = port_data.get_lm_dataset(DataConfig(**kw))
    want = jax_data.get_lm_dataset(JaxDataConfig(**kw))
    if packed:
        assert got[1].shape == got[0].shape and got[1].max() > 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_token_data_config_checks():
    with pytest.raises(ValueError, match="vocab_size must be >= 256"):
        DataConfig(dataset="text_lm", vocab_size=64)
    with pytest.raises(ValueError, match="packs text_lm"):
        DataConfig(dataset="synthetic_lm", pack_docs=True)
    with pytest.raises(ValueError, match="needs a file"):
        port_data.get_lm_dataset(DataConfig(dataset="text_lm"))


# -- sampling ------------------------------------------------------------


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (3, 0.0), (0, 0.5),
                                         (4, 0.7), (1, 0.95), (64, 0.3)])
def test_filter_logits_masks_equal_tpunets(top_k, top_p):
    rng = np.random.default_rng(top_k)
    # Rounded to a coarse grid: many ties, at the cut-offs too.
    lg = np.round(rng.normal(0, 2, (5, 64)) * 2) / 2
    lg = lg.astype(np.float32)
    want = np.asarray(jax_filter_logits(jnp.asarray(lg), top_k=top_k,
                                        top_p=top_p))
    got = filter_logits(torch.from_numpy(lg), top_k=top_k,
                        top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


@pytest.mark.parametrize("use_cache", [True, False], ids=["cache",
                                                           "no_cache"])
def test_greedy_generate_equals_tpunets(params, use_cache):
    prompt = _tokens(3, 7, 6)
    want = np.asarray(jax_generate(jax_lm(), {"params": params}, prompt, 20,
                                   use_cache=use_cache))
    got = generate(port_lm(params), torch.from_numpy(prompt), 20,
                   use_cache=use_cache)
    assert got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_streams_repeat_by_seed(params):
    port = port_lm(params)
    prompt = torch.from_numpy(_tokens(2, 5, 7))

    def run(seed, use_cache=True):
        return generate(port, prompt, 24, temperature=0.9, top_k=8,
                        top_p=0.9, use_cache=use_cache,
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Both paths draw the j-th sample for new token j.
    assert torch.equal(run(1, use_cache=False), a)


# -- the generate CLI ------------------------------------------------------


def _cli_pair(tmp_path, monkeypatch, capsys, params, flags, **cfg):
    """The port's and tpunet's ``main`` on the same weights: stdout of
    each."""
    model = create_model(ModelConfig(**dict(LM, **cfg)), device="cpu")
    load_state_dict(model, lm_state_dict_from_jax(params))
    torch.save(model.state_dict(), tmp_path / "best.pth")
    gen_cli.main(["--checkpoint-dir", str(tmp_path), "--device", "cpu",
                  *flags])
    got = capsys.readouterr().out
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    monkeypatch.setattr(jax_gen_cli, "load_lm", lambda cfg, **kw: (
        jax_lm(**{k: v for k, v in cfg.__dict__.items()
                  if k in ("vocab_size", "max_seq_len")}),
        {"params": jparams}))
    jax_gen_cli.main(["--checkpoint-dir", str(tmp_path), *flags])
    return got, capsys.readouterr().out


def test_generate_cli_prints_what_tpunets_prints(tmp_path, monkeypatch,
                                                 capsys, params):
    flags = ["--vit-hidden", "32", "--vit-depth", "2", "--vit-heads", "2",
             "--vocab-size", "64", "--max-seq-len", "80", "--prompt",
             "5 9 2 33", "--tokens", "16"]
    got, want = _cli_pair(tmp_path, monkeypatch, capsys, params, flags)
    assert got == want and len(got.split()) == 20


def test_generate_cli_bytes_prompt(tmp_path, monkeypatch, capsys):
    params = lm_params(1, vocab_size=256)
    flags = ["--vit-hidden", "32", "--vit-depth", "2", "--vit-heads", "2",
             "--max-seq-len", "80", "--prompt", "The ", "--tokens", "12"]
    got, want = _cli_pair(tmp_path, monkeypatch, capsys, params, flags,
                          vocab_size=256)
    assert got == want and got.startswith("The ")


@pytest.mark.parametrize("flags,match", [
    # --mesh-model is ported: the default 3 heads do not split over 2
    # ranks (exit 2, tpunet's message), and 4 heads need the 2 processes
    # of a torchrun launch.
    (["--model", "lm_pp", "--mesh-model", "2"], "^2 --vit-heads 3 not "
     "divisible by the mesh 'model' axis"),
    (["--vit-hidden", "32", "--vit-heads", "4", "--mesh-model", "2"],
     "needs 2 processes, have 1"),
    (["--model", "lm_pp", "--moe-experts", "4", "--mesh-model", "2"],
     "^2 --vit-heads 3 not divisible"),
    (["--top-k", "3"], "temperature"),
    (["--tokens", "2000"], "exceeds --max-seq-len"),
    (["--vocab-size", "64", "--prompt-format", "bytes"], "vocab-size 256"),
    (["--prompt-format", "ids", "--prompt", "a b"], "token ids")],
    ids=["lm_pp", "mesh", "moe", "top_k", "too_long", "bytes", "ids"])
def test_generate_cli_refusals(flags, match, capsys):
    """The refusal's SystemExit (its code or message), then what the CLI
    said on stderr."""
    with pytest.raises(SystemExit) as e:
        gen_cli.main(["--device", "cpu", *flags])
    err = capsys.readouterr().err.split("error: ")[-1]
    assert re.search(match, f"{e.value.code} {err}")
