"""One rank of the port's sharded-state CPU tests (tests/test_torch_tp.py,
tests/test_torch_fsdp.py, tests/test_torch_vocab_ce.py).

    python tests/_torch_shard_worker.py DIR WORLD RANK CASE...

joins a gloo process group of WORLD ranks through a file store in DIR and
runs each CASE in turn on the inputs the test wrote into DIR, saving what
it computed to ``DIR/<case>_rank<RANK>.pt``:

- ``vocab``: ``vocab_parallel_ce`` over a 'model' group of WORLD ranks on
  ``vocab.npz`` (h, emb, targets), with smoothing 0 and 0.1: the CE, the
  hits and the gradients of the CE's mean with respect to h and emb;
- ``vit_grad``: the tiny ViT of ``vit.pt`` cut for tensor parallelism
  over WORLD ranks, one train-mode forward/backward (dropout 0) on
  ``images.npz``: the logits, the loss and the whole gradients;
- ``lm``/``vit``/``mnv2``/``mnv2_fsdp``/``mnv2_zero1``: ``python -m
  tpunet_torch.train --preset distributed`` for one epoch with the flags
  in ``flags.json`` under that name (the CLI in this process); the epoch
  record, and at the end of the run this rank's parameters as its model
  computes with them (FSDP's gathered), its optimizer state (the pieces
  it keeps) with their splits, each replicated leaf's largest gradient
  gap to the 'model' group's mean (``Sharding.replicated_gaps``), and
  the sizes of what it keeps resident, taken before the run leaves its
  group (the sequence-parallel runs of tests/test_torch_seq_train.py
  too);
- ``seq_s2``/``seq_s4``/``seq_tp`` (tests/test_torch_seq.py): on a mesh
  of 'seq' 2 (2 ranks), 'seq' 4 (4 ranks) or 'seq' 2 x 'model' 2 (4
  ranks), the rank's shard of ``seq_qkv.npz`` (its tokens, and under
  'model' its heads) through ``ring_self_attention`` and
  ``ulysses_self_attention`` with each core, causal and not: the output
  and the q/k/v gradients of sum(out^2) over every rank's output; the
  flash ring in bf16; and on 'seq' 2 the errors of an unknown core,
  indivisible heads, Ulysses on cross-length inputs and the flash core
  on a causal cross-length ring;
- ``moe_m2``/``moe_d2m2`` (tests/test_torch_moe.py): on a mesh of
  'model' 2 (2 ranks) or 'data' 2 x 'model' 2 (4 ranks), ``moe_apply``
  on the rank's experts (and rows) of ``moe_ep.npz`` under each
  lowering: the output, the aux term and the gradients;
- ``seq_vit_grad``: the tiny ViT of ``vit.pt`` with ring attention over
  a 'seq' axis of WORLD ranks, one train-mode forward/backward (dropout
  0) on ``images.npz`` with the loss split over the ranks and the
  gradients summed over 'seq', as the train step does;
- ``pp_toy`` (tests/test_torch_pp.py): a 'pipe' axis of WORLD stages
  over the toy stack of ``pp_toy.npz`` (tanh(x @ w) layers), each
  schedule at each microbatch count of the file: the last stage's
  outputs of a forward-only run, then a training run's weight
  gradients (this stage's layers), the input's gradient (stage 0) and
  the most graphs a stage kept; an interleaved run whose microbatches
  the stages do not divide gives its error. The CLI runs of
  tests/test_torch_{vitpp,lmpp}.py add each rank's pipeline plan
  (layers, ``max_live``, the last run's ticks and hops);
- ``tp_generate``/``tp_int8``/``tp_engine`` (tests/test_torch_tp_serve.py):
  on a mesh of data 1 x model WORLD, ``load_lm`` of each checkpoint of
  ``tp_serve.json`` cut for tensor parallelism and ``generate`` (KV
  cache, no cache, sampled) on its shard; ``quantize_kv_rows`` on the
  rank's heads of ``tp_int8.npz`` with the absmax over the group, the
  codes all-gathered; and each engine configuration of the file over
  its shard, rank 0 serving the prompts while the others follow its op
  stream (the greedy tokens, the counters, the ops sent, the pool's
  bytes), then a warm start from the one-card replica's store and the
  adopted pages read back through the heads' all-gather.

Imports no JAX and nothing of the tpunet package.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpunet_torch.config import MeshConfig, ModelConfig  # noqa: E402
from tpunet_torch.models import create_model  # noqa: E402
from tpunet_torch.models.convert import gather_tensor, shard_model  # noqa: E402
from tpunet_torch.ops.vocab_ce import vocab_parallel_ce  # noqa: E402
from tpunet_torch.parallel import dist  # noqa: E402
from tpunet_torch.parallel.mesh import (axis_group, make_mesh,  # noqa: E402
                                        set_mesh)
from tpunet_torch.parallel.tp import compute_spec, layout  # noqa: E402
from tpunet_torch.train import __main__ as cli  # noqa: E402
from tpunet_torch.train import loop  # noqa: E402

VIT = dict(name="vit", vit_patch=4, vit_hidden=64, vit_depth=2, vit_heads=4,
           dtype="float32", dropout_rate=0.0)


def case_vocab(d, world, rank):
    make_mesh(MeshConfig(model=world))
    inputs = np.load(os.path.join(d, "vocab.npz"))
    out = {}
    for s in (0.0, 0.1):
        h = torch.from_numpy(inputs["h"]).requires_grad_()
        emb = torch.from_numpy(inputs["emb"]).requires_grad_()
        ce, hit = vocab_parallel_ce(h, emb, torch.from_numpy(inputs["tgt"]),
                                    axis_group("model"), smoothing=s)
        ce.mean().backward()
        out[s] = dict(ce=ce.detach(), hit=hit, dh=h.grad, demb=emb.grad)
    set_mesh(None)
    return out


def case_vit_grad(d, world, rank):
    mesh = make_mesh(MeshConfig(model=world))
    cfg = ModelConfig(**VIT)
    model = create_model(cfg, device="cpu", image_size=32)
    model.load_state_dict(torch.load(os.path.join(d, "vit.pt")))
    table = layout({k: tuple(p.shape) for k, p in model.named_parameters()},
                   cfg, mesh.shape)
    assert shard_model(model, table, cfg)
    inputs = np.load(os.path.join(d, "images.npz"))
    x = torch.from_numpy(inputs["x"]).permute(0, 3, 1, 2)
    logits = model(x, train=True, generator=torch.Generator())
    loss = F.cross_entropy(logits, torch.from_numpy(inputs["y"]))
    loss.backward()
    grads = {k: gather_tensor(p.grad, compute_spec(table[k]))
             for k, p in model.named_parameters()}
    set_mesh(None)
    return dict(logits=logits.detach(), loss=loss.item(), grads=grads)


SEQ_MESHES = {"seq_s2": dict(seq=2), "seq_s4": dict(seq=4),
              "seq_tp": dict(seq=2, model=2)}


def case_seq(d, world, rank, name):
    from tpunet_torch.ops.attention import (ring_self_attention,
                                            ulysses_self_attention)
    mesh = make_mesh(MeshConfig(**SEQ_MESHES[name]))
    n, r = mesh.shape["seq"], mesh.coords["seq"]
    m, j = mesh.shape["model"], mesh.coords["model"]
    qkv = [torch.from_numpy(a) for a in np.load(
        os.path.join(d, "seq_qkv.npz")).values()]
    t, h = qkv[0].shape[1], qkv[0].shape[2]
    mine = [a[:, r * t // n:(r + 1) * t // n, j * h // m:(j + 1) * h // m]
            for a in qkv]
    fns = {"ring": ring_self_attention, "ulysses": ulysses_self_attention}
    out = {}
    for attn, fn in fns.items():
        for core in ("blockwise", "flash"):
            for causal in (False, True):
                x = [a.clone().requires_grad_() for a in mine]
                y = fn(*x, causal=causal, core=core)
                (y ** 2).sum().backward()
                out[(attn, core, causal)] = dict(
                    out=y.detach(), grads=[a.grad for a in x])
    x = [a.bfloat16() for a in mine]
    out["bf16_ring"] = ring_self_attention(*x, causal=True,
                                           core="flash").float()
    if name == "seq_s2":
        q, k, v = mine
        errors = {}
        for tag, call in (
                ("unknown_core", lambda: ring_self_attention(
                    q, k, v, core="blokwise")),
                ("indivisible_heads", lambda: ulysses_self_attention(
                    q[:, :, :3], k[:, :, :3], v[:, :, :3])),
                ("cross_length", lambda: ulysses_self_attention(
                    q, k[:, :8], v[:, :8])),
                ("flash_causal_cross_length", lambda: ring_self_attention(
                    q, k[:, :8], v[:, :8], causal=True, core="flash"))):
            try:
                call()
                errors[tag] = None
            except ValueError as e:
                errors[tag] = str(e)
        out["errors"] = errors
    set_mesh(None)
    return out


def case_seq_vit_grad(d, world, rank):
    from tpunet_torch.train.state import sum_over_seq
    make_mesh(MeshConfig(seq=world))
    cfg = ModelConfig(attention="ring", **VIT)
    model = create_model(cfg, device="cpu", image_size=32)
    model.load_state_dict(torch.load(os.path.join(d, "vit.pt")))
    inputs = np.load(os.path.join(d, "images.npz"))
    x = torch.from_numpy(inputs["x"]).permute(0, 3, 1, 2)
    logits = model(x, train=True, generator=torch.Generator())
    loss = F.cross_entropy(logits, torch.from_numpy(inputs["y"]))
    (loss / world).backward()
    grads = [p.grad for p in model.parameters()]
    sum_over_seq(grads)
    set_mesh(None)
    return dict(logits=logits.detach(), loss=loss.item(),
                grads={k: p.grad for k, p in model.named_parameters()})


# The expert-parallel meshes of tests/test_torch_moe.py.
MOE_MESHES = {"moe_m2": dict(model=2), "moe_d2m2": dict(data=2, model=2)}


def case_moe(d, world, rank, name):
    """``moe_apply`` on the rank's experts of ``moe_ep.npz`` (and under
    'data' its rows of the tokens), each lowering, at each capacity
    factor of the file: the output, the aux term and the gradients of
    sum(y^2) + 0.01 * aux / data (the aux's share of a 'data' rank)."""
    from tpunet_torch.models.moe import moe_apply
    mesh = make_mesh(MeshConfig(**MOE_MESHES[name]))
    dd, di = mesh.shape["data"], mesh.coords["data"]
    m, j = mesh.shape["model"], mesh.coords["model"]
    inputs = dict(np.load(os.path.join(d, "moe_ep.npz")))
    n, e = inputs["x"].shape[0], inputs["rw"].shape[0]
    out = {}
    for impl in ("replicated", "alltoall"):
        for cf in inputs["factors"].tolist():
            t = {k: torch.from_numpy(inputs[k]).requires_grad_()
                 for k in ("x", "rw", "rb", "wi", "bi", "wo", "bo")}
            x = t["x"][di * n // dd:(di + 1) * n // dd]
            experts = [t[k][j * e // m:(j + 1) * e // m]
                       for k in ("wi", "bi", "wo", "bo")]
            y, aux = moe_apply(x, t["rw"], t["rb"], *experts, num_experts=e,
                               top_k=2, capacity_factor=cf,
                               dtype=torch.float32,
                               ep_group=axis_group("model"), ep_impl=impl)
            ((y ** 2).sum() + 0.01 * aux / dd).backward()
            out[(impl, cf)] = dict(
                y=y.detach(), aux=aux.detach(),
                grads={k: v.grad for k, v in t.items()})
    return out


def case_pp_toy(d, world, rank):
    from tpunet_torch.parallel.pp import PipePlan, StageWork
    make_mesh(MeshConfig(pipe=world))
    inputs = np.load(os.path.join(d, "pp_toy.npz"))
    weights = torch.from_numpy(inputs["w"])
    out = {}
    for m_count in inputs["micro"].tolist():
        for sched in ("gpipe", "1f1b", "interleaved"):
            try:
                plan = PipePlan(weights.shape[0], world, rank, m_count,
                                sched, 2, axis_group("pipe"))
                plan.table(True)
            except ValueError as e:
                out[(sched, m_count)] = dict(error=str(e))
                continue
            w = {i: torch.nn.Parameter(weights[i].clone())
                 for i in plan.layers[rank]}
            x = torch.from_numpy(inputs["x"]).requires_grad_()
            xs = list(x.split(x.shape[0] // m_count))
            dys = list(torch.from_numpy(inputs["dy"]).split(
                x.shape[0] // m_count))

            class Toy(StageWork):
                def __init__(self, train):
                    self.train = train

                def first(self, m):
                    return xs[m]

                def chunk(self, j, h, m):
                    for i in plan.chunks[j]:
                        h = torch.tanh(h @ w[i])
                    return h, None

                def last(self, m, y):
                    return (y * dys[m]).sum() if self.train else y

            act = (x.shape[0] // m_count,) + tuple(x.shape[1:])
            ys = plan.run(Toy(False), False, act, torch.float32, "cpu")
            plan.run(Toy(True), True, act, torch.float32, "cpu")
            out[(sched, m_count)] = dict(
                y=(torch.cat([ys[m] for m in range(m_count)]).detach()
                   if ys else None),
                grads={i: p.grad for i, p in w.items()},
                dx=x.grad if rank == 0 else None, max_live=plan.max_live)
    set_mesh(None)
    return out


TP_LM = dict(vit_hidden=64, vit_depth=2, vit_heads=4, vocab_size=64,
             max_seq_len=48, dtype="float32", dropout_rate=0.0)


def _tp_spec(d):
    return json.load(open(os.path.join(d, "tp_serve.json")))


def case_tp_generate(d, world, rank):
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.models.lm import generate
    mesh = make_mesh(MeshConfig(data=1, model=world))
    spec = _tp_spec(d)
    prompt = torch.tensor(spec["prompt"])
    n = spec["generate_new"]
    out = {}
    for name, entry in spec["generate"].items():
        cfg = ModelConfig(name=entry["model"], **TP_LM, **entry["moe"])
        model = load_lm(cfg, os.path.join(d, entry["dir"]), device="cpu",
                        mesh=mesh)
        out[name] = dict(
            cache=generate(model, prompt, n),
            nocache=generate(model, prompt, n, use_cache=False),
            sampled=generate(model, prompt, n, temperature=1.5,
                             generator=torch.Generator().manual_seed(
                                 rank)),
            qkv_rows=model.blocks[0].attn.qkv.weight.shape[0],
            cache_heads=model.init_cache(1, 8).k[0].shape[2])
    set_mesh(None)
    return out


def case_tp_int8(d, world, rank):
    from tpunet_torch.models.vit import quantize_kv_rows
    make_mesh(MeshConfig(data=1, model=world))
    x = torch.from_numpy(np.load(os.path.join(d, "tp_int8.npz"))["x"])
    h = x.shape[1] // world
    codes, scales = quantize_kv_rows(x[:, rank * h:(rank + 1) * h],
                                     axis_group("model"))
    every = dist.all_gather(codes, axis_group("model"))
    set_mesh(None)
    return dict(codes=torch.cat(list(every.unbind(0)), 1), scales=scales)


def case_tp_engine(d, world, rank):
    from tpunet_torch.config import ServeConfig
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.serve import Engine
    from tpunet_torch.serve.prefixcache import build_prefix_store
    mesh = make_mesh(MeshConfig(data=1, model=world))
    spec = _tp_spec(d)
    lm_cfg = ModelConfig(name="lm", **TP_LM)
    model = load_lm(lm_cfg, os.path.join(d, "ck_lm"), device="cpu",
                    mesh=mesh)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out = {}
    for name, kw in spec["engines"].items():
        kw = dict(kw)
        store_dir = kw.pop("store", None)
        cfg = ServeConfig(**kw)
        store = (build_prefix_store(os.path.join(d, store_dir), lm_cfg, cfg,
                                    device="cpu")
                 if store_dir and rank == 0 else None)
        eng = Engine(model, cfg, prefix_store=store)
        row = dict(kv_bytes_per_token=eng.kv_bytes_per_token(),
                   pool_bytes=eng.kv_pool_bytes())
        if rank != 0:
            eng.follow()
        elif name.startswith("warm"):
            # The one-card replica's spilled pages through this replica's
            # warm start (each rank writes its heads), read back whole.
            eng._warm_start_prefix()
            row["pages"] = {node.digest: eng._read_page_rows(node.page)
                            for node in eng._prefix._nodes.values()}
            eng._stop_followers()
        else:
            eng.start()
            try:
                reqs = [eng.submit(p, max_new_tokens=spec["new"])
                        for p in prompts]
                row["tokens"] = [r.result(timeout=120) for r in reqs]
            finally:
                eng.stop()
            row["snapshot"] = eng.registry.snapshot()
            row["ops"] = dict(eng.ops_sent)
        out[name] = row
    set_mesh(None)
    return out


def case_cli(d, world, rank, name):
    flags = json.load(open(os.path.join(d, "flags.json")))[name]
    seen = {}
    real_close = loop.Trainer.close

    def close(self):
        # Still inside the group: gather FSDP's parameters to read them
        # as the model computes with them (every rank calls this).
        sh = self.state.sharding
        if sh is not None:
            sh.gather()
        seen["params"] = {k: v.detach().clone() for k, v in
                          self.state.model.state_dict().items()}
        opt = self.state.optimizer.state_dict()["state"]
        names = [n for n, _ in self.state.model.named_parameters()]
        seen["moments"] = {names[i]: {k: v.clone() for k, v in st.items()}
                           for i, st in opt.items()}
        pp = getattr(self.state.model, "pp", None)
        if pp is not None:
            seen["pp"] = dict(layers=pp.layers[pp.s], max_live=pp.max_live,
                              stats=dict(pp.stats))
        if sh is not None:
            # As plain tuples (dim, axis, interleave): torch.load's
            # weights_only unpickler takes no other class.
            seen["moment_specs"] = {
                n: None if sh.moment_spec(i) is None
                else tuple(sh.moment_spec(i)) for i, n in enumerate(sh.names)}
            seen["replicated_gaps"] = sh.replicated_gaps()
            sh.release()
            seen["resident"] = dict(
                params=sum(p.numel() for p in self.state.model.parameters()),
                masters=sum(m.numel() for m, f in zip(sh.masters, sh.fsdp)
                            if f),
                moments=sum(t.numel() for st in
                            self.state.optimizer.state.values()
                            for t in st.values() if t.dim() > 0),
                fsdp=[n for n, f in zip(sh.names, sh.fsdp) if f],
                data_split=[n for n, s in zip(sh.names, sh.split)
                            if s is not None])
        real_close(self)

    loop.Trainer.close = close
    try:
        trainer = cli.run(flags + ["--checkpoint-dir",
                                   os.path.join(d, f"ck_{name}")])
    finally:
        loop.Trainer.close = real_close
    dist.initialize_distributed(
        init_method="file://" + os.path.join(d, f"store_after_{name}"),
        world_size=world, rank=rank, device="cpu")
    return dict(history=trainer.history, **seen)


def main() -> int:
    d, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    dist.initialize_distributed(
        init_method="file://" + os.path.join(
            d, f"store_w{world}{os.environ.get('TPUNET_GANG_TAG', '')}"),
        world_size=world, rank=rank, device="cpu")
    assert dist.backend_name() == "gloo"
    for case in sys.argv[4:]:
        if case == "vocab":
            out = case_vocab(d, world, rank)
        elif case == "vit_grad":
            out = case_vit_grad(d, world, rank)
        elif case in SEQ_MESHES:
            out = case_seq(d, world, rank, case)
        elif case in MOE_MESHES:
            out = case_moe(d, world, rank, case)
        elif case == "seq_vit_grad":
            out = case_seq_vit_grad(d, world, rank)
        elif case == "pp_toy":
            out = case_pp_toy(d, world, rank)
        elif case == "tp_generate":
            out = case_tp_generate(d, world, rank)
        elif case == "tp_int8":
            out = case_tp_int8(d, world, rank)
        elif case == "tp_engine":
            out = case_tp_engine(d, world, rank)
        else:
            out = case_cli(d, world, rank, case)
        torch.save(out, os.path.join(d, f"{case}_rank{rank}.pt"))
    # Every rank has joined the last group before any leaves it: a rank
    # that left at once could close its pair while another's gloo
    # connection to it was still being made.
    dist.sync_hosts("done")
    dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
