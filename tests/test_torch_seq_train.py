"""The sequence-parallel trainer of the port (``python -m
tpunet_torch.train --preset distributed --mesh-seq 2 --attention
ring|ulysses``) against tpunet, on the CPU.

Three gangs of 2 gloo ranks (``tests/_torch_shard_worker.py``, the CLI
in each rank's process) run one epoch a case, two cases a gang, float32:

- the LM (hidden 64, depth 2, 4 heads, vocab 32, T 32, batch 8, from
  tpunet's initial weights through ``--pretrained``) under ring and
  under Ulysses, and the packed LM (``text_lm --pack-docs``, vocab 256)
  under Ulysses, each against tpunet's Trainer at the same mesh (data 1
  x seq 2, its ring/Ulysses over the 8-device CPU mesh) with the
  tensor-parallel tests' bounds (tests/test_torch_tp.py): train loss within 1e-4, test
  accuracy within 1e-6, parameters within rtol 2e-4 / atol 2e-5 but the
  key third of the qkv bias, whose exact gradient is 0;
- the tiny ViT (4 heads, 32 px, patch 4: 64 tokens) under ring against
  the port's one-process epoch (its augmentation draws from torch's
  generator, not JAX's; tests/test_torch_seq.py holds the SP ViT's
  forward/backward against tpunet's) at the same bounds;
- the LM ring with ``--remat`` equal to the bit to the run without it
  (the recompute reruns the block's hops in the same order on both
  ranks), and the LM ring at dropout 0.2 against the one-process port
  epoch at dropout 0.2 (each mask is drawn at the whole sequence's
  shape and sliced);

and in every case the parameters are equal to the bit on both ranks
(the 'seq' ranks hold replicas) and equal to the whole state rank 0
saved. ``--pack-docs --attention ring`` is refused with tpunet's
reason, and the flags parse to tpunet's configuration.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tpunet.config import CheckpointConfig as JaxCheckpointConfig
from tpunet.config import DataConfig as JaxDataConfig
from tpunet.config import MeshConfig as JaxMeshConfig
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import OptimConfig as JaxOptimConfig
from tpunet.config import TrainConfig as JaxTrainConfig
from tpunet.config import config_from_args as jax_config_from_args
from tpunet.train.loop import Trainer as JaxTrainer
from tpunet_torch.models.convert import lm_state_dict_from_jax
from tpunet_torch.train import __main__ as cli

import _torch_gang
import _torch_threads  # noqa: F401
from test_torch_tp import (LM, LM_DATA, LM_FLAGS, LM_LR, VIT_FLAGS,
                           check_epoch)

WORLD = 2
SEQ = ["--mesh-seq", "2", "--batch-size", "8"]
PACKED = dict(LM, vocab_size=256)
PACKED_DATA = dict(dataset="text_lm", batch_size=8, seq_len=32,
                   pack_docs=True)


def _corpus(d):
    rng = np.random.default_rng(16)
    words = ["the", "ring", "passes", "keys", "and", "values", "round", "a"]
    lines = [" ".join(rng.choice(words, int(rng.integers(1, 9))))
             for _ in range(120)]
    path = d / "corpus.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _packed_flags(corpus):
    flags = [f for f in LM_FLAGS]
    for name, value in (("--dataset", "text_lm"), ("--vocab-size", "256")):
        flags[flags.index(name) + 1] = value
    i = flags.index("--synthetic-size")
    del flags[i:i + 2]
    return flags + ["--text-file", corpus, "--pack-docs"]


def jax_trainer(attention, d, packed=False, corpus=None) -> JaxTrainer:
    """tpunet's LM Trainer at data 1 x seq 2 with ``attention``, its
    initial weights written to ``d/<attention>.pth`` for the port's
    ``--pretrained``."""
    data = (JaxDataConfig(text_path=corpus, **PACKED_DATA) if packed
            else JaxDataConfig(**LM_DATA))
    trainer = JaxTrainer(JaxTrainConfig(
        epochs=1, data=data,
        model=JaxModelConfig(attention=attention,
                             **(PACKED if packed else LM)),
        optim=JaxOptimConfig(learning_rate=LM_LR),
        mesh=JaxMeshConfig(data=1, seq=2),
        checkpoint=JaxCheckpointConfig(save_best=False, save_last=False)))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(trainer.state.params))
    name = f"{'packed_' if packed else ''}{attention}.pth"
    torch.save(lm_state_dict_from_jax(init), d / name)
    return trainer


def jax_epoch(trainer: JaxTrainer) -> dict:
    host = lambda tree: lm_state_dict_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, jax.device_get(tree)))
    try:
        train = trainer.train_one_epoch(1)
        test = trainer.evaluate()
        return dict(train=train, test=test, params=host(trainer.state.params))
    finally:
        trainer.close()


def port_epoch(flags, d, tag) -> dict:
    """The port's one-process epoch of ``flags`` (``--preset single``)."""
    one = cli.run(["--preset", "single"] + flags + [
        "--checkpoint-dir", str(d / tag)])
    return dict(train={"loss": one.history[0]["train_loss"]},
                test={"accuracy": one.history[0]["test_accuracy"]},
                params={k: v.numpy() for k, v in torch.load(
                    d / tag / "state.pt")["model"].items()})


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqtrain")
    corpus = _corpus(d)
    refs = {"lm_ring": jax_trainer("ring", d),
            "lm_ulysses": jax_trainer("ulysses", d),
            "lmpk_ulysses": jax_trainer("ulysses", d, packed=True,
                                        corpus=corpus)}
    lm_ring = LM_FLAGS + SEQ + ["--attention", "ring", "--pretrained",
                                str(d / "ring.pth")]
    vit = VIT_FLAGS + ["--batch-size", "16"]
    flags = {
        "lm_ring": lm_ring,
        "lm_ulysses": LM_FLAGS + SEQ + ["--attention", "ulysses",
                                        "--pretrained", str(d / "ulysses.pth")],
        "lmpk_ulysses": _packed_flags(corpus) + SEQ + [
            "--attention", "ulysses", "--pretrained",
            str(d / "packed_ulysses.pth")],
        "vit_ring": ["--preset", "distributed"] + vit + [
            "--attention", "ring", "--mesh-seq", "2"],
        "lm_remat": lm_ring + ["--remat"],
        "lm_drop": LM_FLAGS + SEQ + ["--attention", "ring",
                                     "--dropout-rate", "0.2"]}
    (d / "flags.json").write_text(json.dumps(flags))
    # Three gangs of two cases, started together before the references'
    # epochs, each with its own deadline (tests/_torch_gang.py).
    gangs = [_torch_gang.start(d, WORLD, cases, tag=f"g{i}")
             for i, cases in enumerate((["lm_ring", "lm_remat"],
                                        ["lm_ulysses", "lmpk_ulysses"],
                                        ["vit_ring", "lm_drop"]))]
    want = {name: jax_epoch(t) for name, t in refs.items()}
    # The ViT's augmentation and the dropout masks draw from torch's
    # generators: their references are the port's one-process epochs.
    want["vit_ring"] = port_epoch(vit, d, "vit_w1")
    assert LM_FLAGS[:2] == ["--preset", "distributed"]
    want["lm_drop"] = port_epoch(LM_FLAGS[2:] + [
        "--batch-size", "8", "--dropout-rate", "0.2"], d, "lm_drop_w1")
    for gang in gangs:
        _torch_gang.wait(d, WORLD, gang)
    got = {name: [torch.load(d / f"{name}_rank{r}.pt")
                  for r in range(WORLD)] for name in flags}
    return dict(d=d, want=want, got=got)


def _check_ranks(d, name, dumps):
    """Both ranks hold the same parameters, to the bit, and they are
    the whole state rank 0 saved."""
    whole = torch.load(d / f"ck_{name}" / "state.pt")["model"]
    for k, w in whole.items():
        for r, dump in enumerate(dumps):
            assert torch.equal(dump["params"][k], w), (name, k, r)
    return whole


@pytest.mark.parametrize("name", ["lm_ring", "lm_ulysses", "lmpk_ulysses",
                                  "vit_ring", "lm_drop"])
def test_seq_epoch_matches_its_reference(gang, name):
    """The epoch at 'seq' 2 against tpunet's Trainer at the same mesh
    (the LMs) or the port's one-process epoch (the ViT; the LM at
    dropout 0.2)."""
    dumps = gang["got"][name]
    whole = _check_ranks(gang["d"], name, dumps)
    for dump in dumps:
        check_epoch(dump["history"], whole, gang["want"][name], name)


def test_seq_remat_equals_the_run_without(gang):
    got, want = gang["got"]["lm_remat"], gang["got"]["lm_ring"]
    for a, b in zip(got, want):
        assert a["history"][0]["train_loss"] == b["history"][0]["train_loss"]
        for k, v in b["params"].items():
            assert torch.equal(a["params"][k], v), k


def test_pack_docs_refuses_ring_as_tpunet_does(tmp_path):
    corpus = _corpus(tmp_path)
    flags = _packed_flags(corpus) + ["--attention", "ring", "--mesh-seq",
                                     "2"]
    with pytest.raises(ValueError) as got:
        cli.config_from_args(flags)
    with pytest.raises(ValueError) as want:
        JaxTrainer(JaxTrainConfig(
            epochs=1, data=JaxDataConfig(text_path=corpus, **PACKED_DATA),
            model=JaxModelConfig(attention="ring", **PACKED),
            mesh=JaxMeshConfig(data=1, seq=2),
            checkpoint=JaxCheckpointConfig(save_best=False,
                                           save_last=False)))
    assert str(got.value) == str(want.value)
    assert "ring's state-merging core has no segment operands" in str(
        got.value)


@pytest.mark.parametrize("flags", [
    ["--attention", "ring", "--mesh-seq", "2"],
    ["--attention", "ulysses", "--mesh-seq", "4", "--mesh-data", "2",
     "--attention-core", "blockwise"],
    ["--attention", "ring", "--mesh-seq", "2", "--mesh-model", "2",
     "--attention-core", "flash", "--fsdp", "--remat"]],
    ids=["ring", "ulysses_dp", "ring_tp_fsdp"])
def test_seq_flags_parse_to_tpunets_config(flags):
    argv = ["--model", "lm", "--dataset", "synthetic_lm"] + flags
    cfg, _ = cli.config_from_args(argv)
    want = jax_config_from_args(argv)
    for f in dataclasses.fields(cfg.mesh):
        assert getattr(cfg.mesh, f.name) == getattr(want.mesh, f.name), f.name
    for f in ("name", "attention", "attention_core", "attention_block",
              "remat"):
        assert getattr(cfg.model, f) == getattr(want.model, f), f
