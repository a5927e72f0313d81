"""Pipeline parallelism's executor (``tpunet_torch.parallel.pp``) against
tpunet's tables and a sequential stack, on the CPU.

- The schedule tables copied from ``tpunet/parallel/pp.py`` equal
  tpunet's: ``onef1b_schedule`` over tests/test_pp_1f1b.py's cases,
  ``interleaved_layer_order``, ``interleaved_fwd_schedule`` and every
  array of ``interleaved_bwd_schedule`` over
  tests/test_pp_interleaved.py's; the port's op tables keep every
  dependency (a forward after its input's producer, a backward after
  its own forward and its output's consumer's backward, a tick later).
- The three executors on a toy stage (each layer tanh(x @ w)) over
  gloo gangs of S ranks (``tests/_torch_shard_worker.py pp_toy``): at
  (S, M) in {(2, 2), (2, 4), (4, 2), (4, 8)}, interleaved at v 2, the
  last stage's outputs within 2e-5 of the sequential stack, the weight
  gradients (every stage's layers) and the input's within
  tests/test_pp_1f1b.py's rtol 1e-4 / atol 1e-5 of its ``torch.autograd``
  gradients against the same output cotangent; 1f1b never holds more
  than min(S, M) graphs a stage, gpipe holds M; interleaved at (4, 2)
  gives tpunet's error (the microbatches do not fill the stages).
- ``python -m tpunet_torch.train --model lm_pp --mesh-pipe 2`` under each
  schedule (interleaved at v 2), and the packed LM under 1f1b, one epoch
  of float32 at dropout 0 on 2 gloo ranks (data 1 x pipe 2) against
  tpunet's Trainer on the same mesh from the same weights
  (tests/test_torch_lmpp.py's bounds and rank checks: the leaves every
  stage holds equal to the bit on both ranks); the interleaved run's
  checkpoint holds the whole model in plain layer order, and its
  greedy tokens through ``python -m tpunet_torch.infer.generate --model
  lm_pp`` and the server's engine (``--model lm_pp``) equal tpunet's
  ``generate --model lm_pp --train-pipe 2`` on the same weights in
  tpunet's chunk-permuted stacks; tpunet's stacked tree saved as
  ``best.pth`` reads with ``--train-pipe 2 --pp-virtual 2``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.infer import generate as jax_gen_cli
from tpunet.parallel import pp as jpp
from tpunet_torch.infer import generate as gen_cli
from tpunet_torch.models.convert import lm_params_to_jax
from tpunet_torch.parallel import pp

import _torch_gang
import _torch_threads  # noqa: F401
from test_torch_lmpp import (LMPP_FLAGS, check_pp_ranks, jax_pp_trainer,
                             run_gangs)
from test_torch_seq_train import _corpus
from test_torch_tp import check_epoch

ONEF1B_CASES = [(1, 1), (1, 4), (2, 1), (2, 2), (2, 4), (3, 5), (4, 4),
                (4, 8), (5, 3)]
ILEAVE_CASES = [(2, 2, 2), (2, 4, 2), (2, 4, 3), (4, 4, 2), (4, 8, 2),
                (3, 6, 2), (2, 8, 4)]


@pytest.mark.parametrize("s,m", ONEF1B_CASES)
def test_onef1b_schedule_is_tpunets(s, m):
    assert pp.onef1b_schedule(s, m) == jpp.onef1b_schedule(s, m)


@pytest.mark.parametrize("s,m,v", ILEAVE_CASES)
def test_interleaved_tables_are_tpunets(s, m, v):
    assert pp.interleaved_layer_order(s * v * 2, s, v) == \
        jpp.interleaved_layer_order(s * v * 2, s, v)
    assert pp.interleaved_fwd_schedule(s, m, v) == \
        jpp.interleaved_fwd_schedule(s, m, v)
    got, want = (pp.interleaved_bwd_schedule(s, m, v),
                 jpp.interleaved_bwd_schedule(s, m, v))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                      err_msg=k)


def test_alloc_intervals_is_tpunets():
    rng = np.random.default_rng(18)
    iv = []
    for k in range(40):
        a = int(rng.integers(0, 50))
        iv.append((a, a + int(rng.integers(0, 9)), k))
    assert pp._alloc_intervals(iv) == jpp._alloc_intervals(iv)


@pytest.mark.parametrize("sched,s,m", [
    ("gpipe", 2, 4), ("gpipe", 4, 2), ("1f1b", 3, 5), ("1f1b", 4, 8),
    ("interleaved", 2, 4), ("interleaved", 4, 8)])
def test_op_tables_keep_every_dependency(sched, s, m):
    plan = pp.PipePlan(s * 2 * 2, s, 0, m, sched, 2)
    v = plan.v
    done = {}
    for t, row in enumerate(plan.table(True)):
        for d, op in enumerate(row):
            if op is None:
                continue
            kind, mi, j = op
            assert (kind, d, mi, j) not in done
            if kind == "F":
                prev = plan.prev_of(d, j)
                if prev is not None:
                    assert done[("F", *prev[:1], mi, prev[1])] < t
            else:
                assert done[("F", d, mi, j)] < t
                nxt = plan.next_of(d, j)
                if nxt is not None:
                    assert done[("B", nxt[0], mi, nxt[1])] < t
            done[(kind, d, mi, j)] = t
    assert len(done) == 2 * s * m * v


L, B, T, C = 8, 16, 4, 16
GANGS = {2: [2, 4], 4: [2, 8]}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp_toy")
    rng = np.random.default_rng(18)
    x = rng.normal(0, 1, (B, T, C)).astype(np.float32)
    w = (rng.normal(0, 1, (L, C, C)) / np.sqrt(C)).astype(np.float32)
    dy = rng.normal(0, 1, (B, T, C)).astype(np.float32)
    out = {}
    for world, micro in GANGS.items():
        sub = d / f"s{world}"
        sub.mkdir()
        np.savez(sub / "pp_toy.npz", x=x, w=w, dy=dy,
                 micro=np.asarray(micro))
        out[world] = (sub, _torch_gang.start(sub, world, ["pp_toy"]))
    # The sequential stack and its gradients against the cotangent dy.
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w[i]).requires_grad_() for i in range(L)]
    h = xt
    for i in range(L):
        h = torch.tanh(h @ wt[i])
    (h * torch.from_numpy(dy)).sum().backward()
    want = dict(y=h.detach(), dx=xt.grad, dw=[g.grad for g in wt])
    got = {}
    for world, (sub, gang) in out.items():
        _torch_gang.wait(sub, world, gang)
        got[world] = [torch.load(sub / f"pp_toy_rank{r}.pt")
                      for r in range(world)]
    return got, want


CASES = [(s, m, sched) for s, ms in GANGS.items() for m in ms
         for sched in ("gpipe", "1f1b", "interleaved")]


@pytest.mark.parametrize("s,m,sched", CASES,
                         ids=[f"{c[2]}_s{c[0]}_m{c[1]}" for c in CASES])
def test_executor_matches_the_sequential_stack(toy, s, m, sched):
    got, want = toy
    ranks = got[s]
    if sched == "interleaved" and m % s:
        msg = ranks[0][(sched, m)]["error"]
        with pytest.raises(ValueError) as e:
            jpp.interleaved_bwd_schedule(s, m, 2)
        assert msg == str(e.value)
        return
    last = ranks[-1][(sched, m)]
    np.testing.assert_allclose(last["y"].numpy(), want["y"].numpy(),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(ranks[0][(sched, m)]["dx"].numpy(),
                               want["dx"].numpy(), rtol=1e-4, atol=1e-5)
    seen = set()
    for r in ranks:
        for i, g in r[(sched, m)]["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["dw"][i].numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"layer {i}")
            seen.add(i)
    assert seen == set(range(L))
    live = [r[(sched, m)]["max_live"] for r in ranks]
    if sched == "1f1b":
        assert max(live) <= min(s, m) and live[0] == min(s, m), live
    elif sched == "gpipe":
        assert live == [m] * s, live


# ------------------------------------------------------ the trainer's runs

@pytest.fixture(scope="module")
def pp_gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp_train")
    corpus = _corpus(d)
    two = LMPP_FLAGS + ["--mesh-pipe", "2", "--batch-size", "8"]
    packed = [f for f in two]
    for name, value in (("--dataset", "text_lm"), ("--vocab-size", "256")):
        packed[packed.index(name) + 1] = value
    i = packed.index("--synthetic-size")
    del packed[i:i + 2]
    flags = {f"lmpp_{tag}": two + ["--pp-schedule", sched, "--pretrained",
                                   str(d / f"{tag}.pth")]
             for tag, sched in (("gpipe", "gpipe"), ("1f1b", "1f1b"),
                                ("ileave", "interleaved"))}
    flags["lmpp_packed"] = packed + [
        "--pp-schedule", "1f1b", "--text-file", corpus, "--pack-docs",
        "--pretrained", str(d / "packed.pth")]
    pipe = dict(data=1, pipe=2)
    refs = {"lmpp_gpipe": jax_pp_trainer(d, "gpipe", pipe),
            "lmpp_1f1b": jax_pp_trainer(d, "1f1b", pipe,
                                        dict(pp_schedule="1f1b")),
            "lmpp_ileave": jax_pp_trainer(
                d, "ileave", pipe, dict(pp_schedule="interleaved"),
                layout=dict(pipe=2, virtual=2)),
            "lmpp_packed": jax_pp_trainer(
                d, "packed", pipe, dict(pp_schedule="1f1b", vocab_size=256),
                dict(dataset="text_lm", text_path=corpus, pack_docs=True,
                     vocab_size=256))}
    want, got = run_gangs(d, flags, [
        (2, ["lmpp_gpipe", "lmpp_ileave"]), (2, ["lmpp_1f1b", "lmpp_packed"])],
        refs)
    return dict(d=d, want=want, got=got)


@pytest.mark.parametrize("name", ["lmpp_gpipe", "lmpp_1f1b", "lmpp_ileave",
                                  "lmpp_packed"])
def test_schedule_epoch_matches_tpunets_trainer(pp_gang, name):
    dumps = pp_gang["got"][name]
    whole = check_pp_ranks(pp_gang["d"], name, dumps)
    for dump in dumps:
        check_epoch(dump["history"], whole, pp_gang["want"][name], name)


def test_interleaved_run_holds_chunks_and_saves_plain_order(pp_gang):
    """Stage d of the interleaved run at v 2 holds layers d and 2 + d
    (chunks j*S + d), and its state.pt the whole model under the LM's
    keys with tpunet's metadata beside them."""
    d = pp_gang["d"]
    for r, dump in enumerate(pp_gang["got"]["lmpp_ileave"]):
        assert dump["pp"]["layers"] == [r, 2 + r]
    saved = torch.load(d / "ck_lmpp_ileave" / "state.pt")
    assert (saved["pp_schedule"], saved["pp_layout_pipe"],
            saved["pp_layout_virtual"]) == ("interleaved", 0, 0)
    assert "layer_order" not in saved
    assert {k.split(".")[1] for k in saved["model"]
            if k.startswith("blocks.")} == {"0", "1", "2", "3"}
    assert len(saved["optimizer"]["state"]) == len(
        saved["optimizer"]["param_groups"][0]["params"])


def test_interleaved_checkpoint_generates_tpunets_tokens(
        pp_gang, tmp_path, monkeypatch, capsys):
    """The port's interleaved run's best.pth (plain layer order) through
    the generate CLI and the server's engine, against tpunet's generate
    on the same weights in its chunk-permuted stacks."""
    ck = pp_gang["d"] / "ck_lmpp_ileave"
    sd = torch.load(ck / "best.pth")
    meta = json.loads((ck / "best_meta.json").read_text())
    assert meta == {"model": "lm_pp", "pp_schedule": "interleaved",
                    "pp_layout_pipe": 0, "pp_layout_virtual": 0}
    stacked = lm_params_to_jax(sd, stacked=True, pipe=2, virtual=2)
    flags = ["--model", "lm_pp", "--vit-hidden", "32", "--vit-depth", "4",
             "--vit-heads", "2", "--vocab-size", "32", "--max-seq-len", "32",
             "--prompt", "5 9 2 30", "--tokens", "12"]
    gen_cli.main(["--checkpoint-dir", str(ck), "--device", "cpu", *flags])
    got = capsys.readouterr().out
    real = jax_gen_cli.load_lm
    monkeypatch.setattr(jax_gen_cli, "load_lm", lambda cfg, **kw: real(
        cfg, variables={"params": jax.tree_util.tree_map(jnp.asarray,
                                                         stacked)},
        train_pipe=kw["train_pipe"]))
    jax_gen_cli.main(["--checkpoint-dir", str(ck), "--train-pipe", "2",
                      "--pp-virtual", "2", *flags])
    want = capsys.readouterr().out
    assert got == want and len(got.split()) == 16
    # tpunet's stacked tree as best.pth: --train-pipe/--pp-virtual unstack.
    (tmp_path / "stk").mkdir()
    torch.save(jax.tree_util.tree_map(torch.from_numpy, stacked),
               tmp_path / "stk" / "best.pth")
    gen_cli.main(["--checkpoint-dir", str(tmp_path / "stk"), "--device",
                  "cpu", "--train-pipe", "2", "--pp-virtual", "2", *flags])
    assert capsys.readouterr().out == want
    # The server (--model lm_pp): its engine's greedy stream is generate's.
    from tpunet_torch.serve.__main__ import build_argparser, build_server
    srv = build_server(build_argparser().parse_args([
        "--checkpoint-dir", str(ck), "--device", "cpu", "--model", "lm_pp",
        "--vit-hidden", "32", "--vit-depth", "4", "--vit-heads", "2",
        "--vocab-size", "32", "--max-seq-len", "32", "--prefill-buckets",
        "8", "--slots", "2"]))
    eng = srv.engine.start()
    try:
        out = eng.submit([5, 9, 2, 30], max_new_tokens=12).result(timeout=120)
    finally:
        eng.stop()
    assert [int(t) for t in want.split()[4:]] == list(out)


def test_pipeline_checkpoint_resumes_as_the_lm(pp_gang, tmp_path):
    """A 1f1b run's whole state.pt (plain layer order, the optimizer
    indexed by the whole model's parameters) resumes in one process as
    ``--model lm``: the restored model and moments are the saved ones."""
    import shutil

    from tpunet_torch.train import __main__ as cli
    from tpunet_torch.train.loop import Trainer

    ck = tmp_path / "ck"
    shutil.copytree(pp_gang["d"] / "ck_lmpp_1f1b", ck)
    saved = torch.load(ck / "state.pt")
    flags = list(LMPP_FLAGS)
    flags[flags.index("--preset") + 1] = "single"
    flags[flags.index("lm_pp")] = "lm"
    cfg, _ = cli.config_from_args(flags + [
        "--batch-size", "8", "--epochs", "2", "--resume",
        "--checkpoint-dir", str(ck)])
    trainer = Trainer(cfg, device="cpu")
    try:
        assert trainer.start_epoch == 2
        for k, v in trainer.state.model.state_dict().items():
            assert torch.equal(v, saved["model"][k]), k
        got = trainer.state.optimizer.state_dict()["state"]
        for i, st in saved["optimizer"]["state"].items():
            assert torch.equal(got[i]["exp_avg_sq"], st["exp_avg_sq"]), i
    finally:
        trainer.close()
