"""The port's native host batcher (``tpunet_torch/data/native.py``, the
unchanged ``cxx/batcher.cc``), on the CPU.

Mirrors of tests/test_native.py: the gather and the prefetcher give the
port's numpy loader's batches to the bit, in tpunet's index order (the
port's ``host_index_sequence`` equals tpunet's); the Trainer's epoch
metrics are equal with and without the native loader, for the image
models and the LM; packed documents and ``--no-native-loader`` take
numpy, and the "Host loader:" line names the loader that runs; the
library is built at first use under ``build/tpunet_torch/``; a crash
report of a process that ran the prefetcher holds its native journal.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpunet.data.pipeline import host_index_sequence as jax_index_sequence
from tpunet_torch.config import (CheckpointConfig, DataConfig, ModelConfig,
                                 TrainConfig)
from tpunet_torch.data import native
from tpunet_torch.data.pipeline import host_index_sequence, train_batches
from tpunet_torch.train.loop import Trainer
import _torch_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(997, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, size=997).astype(np.int32)
    return x, y


def test_library_builds_at_first_use_under_build():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "tpunet_torch"
    assert not (ROOT / "tpunet_torch" / "data" / "_lib").exists()


def test_index_sequence_is_tpunets():
    for kw in (dict(), dict(process_index=1, process_count=2)):
        np.testing.assert_array_equal(
            host_index_sequence(997, global_batch=32, seed=4, epoch=3, **kw),
            jax_index_sequence(997, global_batch=32, seed=4, epoch=3, **kw))


def test_gather_rows_matches_numpy(data):
    x, _ = data
    idx = np.random.default_rng(0).permutation(len(x))[:300]
    np.testing.assert_array_equal(native.gather_rows(x, idx), x[idx])


def test_gather_rows_single_thread(data):
    x, _ = data
    idx = np.asarray([5, 5, 0, 996], dtype=np.int64)
    np.testing.assert_array_equal(
        native.gather_rows(x, idx, n_threads=1), x[idx])


def test_prefetcher_matches_python_pipeline(data):
    x, y = data
    gb = 64
    pf = native.NativePrefetcher(x, y, local_batch=gb, depth=2, n_threads=2)
    for epoch in (0, 1):
        idx = host_index_sequence(len(x), global_batch=gb, seed=42,
                                  epoch=epoch)
        got = list(pf.iter_epoch(idx))
        want = list(train_batches(x, y, global_batch=gb, seed=42,
                                  epoch=epoch))
        assert len(got) == len(want) == len(x) // gb
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    pf.close()


def test_prefetcher_multi_host_slices(data):
    x, y = data
    gb = 32
    seqs = [host_index_sequence(len(x), global_batch=gb, seed=1, epoch=4,
                                process_index=p, process_count=2)
            for p in range(2)]
    pf = native.NativePrefetcher(x, y, local_batch=gb // 2)
    per_host = [list(pf.iter_epoch(s)) for s in seqs]
    pf.close()
    want = list(train_batches(x, y, global_batch=gb, seed=1, epoch=4))
    for s, (wx, wy) in enumerate(want):
        gx = np.concatenate([per_host[p][s][0] for p in range(2)])
        gy = np.concatenate([per_host[p][s][1] for p in range(2)])
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_gather_rows_int32_tokens():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, size=(257, 96)).astype(np.int32)
    idx = rng.permutation(len(toks))[:100]
    np.testing.assert_array_equal(native.gather_rows(toks, idx), toks[idx])


def test_prefetcher_int32_tokens_match_python_pipeline():
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, size=(200, 64)).astype(np.int32)
    y = np.zeros(200, np.int32)
    gb = 32
    pf = native.NativePrefetcher(toks, y, local_batch=gb, depth=2,
                                 n_threads=2)
    idx = host_index_sequence(len(toks), global_batch=gb, seed=7, epoch=2)
    got = list(pf.iter_epoch(idx))
    want = list(train_batches(toks, y, global_batch=gb, seed=7, epoch=2))
    pf.close()
    assert len(got) == len(want) == len(toks) // gb
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_journal_records_the_gather():
    native.gather_rows(np.zeros((4, 4), np.uint8), np.arange(4))
    entries = native.journal_entries()
    assert any(e["op"] == "gather" for e in entries)
    seqs = [e["seq"] for e in entries]
    assert seqs == sorted(seqs) and all(s > 0 for s in seqs)


# -- the Trainer ---------------------------------------------------------------


IMAGE = dict(data=dict(dataset="synthetic", image_size=32, batch_size=16,
                       synthetic_train_size=48, synthetic_test_size=20),
             model=dict(dtype="float32", width_mult=0.5,
                        use_pallas_depthwise=True))
LM = dict(data=dict(dataset="synthetic_lm", batch_size=8, seq_len=16,
                    vocab_size=32, synthetic_train_size=32,
                    synthetic_test_size=8),
          model=dict(name="lm", vit_hidden=32, vit_depth=1, vit_heads=2,
                     vocab_size=32, max_seq_len=16, dtype="float32",
                     dropout_rate=0.0))


def _cfg(directory, kind, native_loader=True):
    return TrainConfig(
        epochs=2, seed=3,
        data=DataConfig(native_loader=native_loader, **kind["data"]),
        model=ModelConfig(**kind["model"]),
        checkpoint=CheckpointConfig(directory=str(directory)))


@pytest.mark.parametrize("kind", [IMAGE, LM], ids=["mobilenet_v2", "lm"])
def test_trainer_metrics_equal_with_and_without_native(tmp_path, kind,
                                                       capsys):
    histories = []
    for on in (True, False):
        trainer = Trainer(_cfg(tmp_path / str(on), kind, on), device="cpu")
        assert (trainer._prefetcher is not None) == on
        try:
            histories.append(trainer.train())
        finally:
            trainer.close()
        out = capsys.readouterr().out
        line = ("Host loader: native C++ prefetcher" if on
                else "Host loader: numpy")
        assert line in out.splitlines()
    drop = ("seconds", "examples_per_sec", "tokens_per_sec", "run_id",
            "config_fingerprint")
    a, b = ([{k: v for k, v in r.items() if k not in drop} for r in h]
            for h in histories)
    assert a == b and len(a) == 2


def test_packed_documents_take_numpy(tmp_path):
    text = tmp_path / "docs.txt"
    text.write_text("\n".join(f"document {i} " * (i % 5 + 1)
                              for i in range(60)))
    cfg = TrainConfig(
        epochs=1,
        data=DataConfig(dataset="text_lm", text_path=str(text),
                        pack_docs=True, seq_len=32, batch_size=4),
        model=ModelConfig(name="lm", vit_hidden=32, vit_depth=1,
                          vit_heads=2, max_seq_len=32, dtype="float32",
                          dropout_rate=0.0),
        checkpoint=CheckpointConfig(directory=str(tmp_path / "ck")))
    trainer = Trainer(cfg, device="cpu")
    try:
        assert cfg.data.native_loader and trainer._prefetcher is None
    finally:
        trainer.close()


_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from tpunet_torch.data import native
from tpunet_torch.obs import flightrec

flightrec.install({workdir!r})
rows = np.arange(64 * 12, dtype=np.uint8).reshape(64, 12)
pf = native.NativePrefetcher(rows, np.arange(64, dtype=np.int32), 8)
next(pf.iter_epoch(np.arange(64)))
flightrec.record("test", "about to die")
os.abort()
"""


def test_crash_report_holds_the_native_journal(tmp_path):
    workdir = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=str(ROOT),
                                             workdir=workdir)],
        capture_output=True, text=True, timeout=180,
        env=_torch_threads.child_env())
    assert proc.returncode != 0
    report = os.path.join(workdir, "flightrec", "crash_report.json")
    deadline = time.monotonic() + 20.0
    while not os.path.exists(report) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert os.path.exists(report), proc.stderr
    with open(report) as f:
        rep = json.load(f)
    nj = rep["native_journal"]
    assert nj is not None and nj["signal"] == int(signal.SIGABRT)
    ops = [o["op"] for o in nj["ops"]]
    assert "create" in ops and "batch_alloc" in ops
    assert rep["cause"] == "SIGABRT"
