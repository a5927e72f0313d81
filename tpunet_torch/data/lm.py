"""Language-modeling data: a framework-free copy of ``tpunet/data/lm.py``.

For one seed (or one file) every array is bit-equal to tpunet's. The
synthetic generator backs the LM family's tests and demos in no-egress
environments. Sequences follow a seeded random bigram
process: each token has one preferred successor taken with probability
0.8 (uniform otherwise), so a causal LM has real, learnable structure
(a perfect model reaches ~0.8 next-token accuracy; a uniform guesser
1/vocab) while the data stays hermetic and deterministic.

Returned in the Trainer's (train_x, train_y, test_x, test_y)
convention; for token data the y arrays are per-sequence dummy labels
(the LM steps derive targets by shifting x — train/steps.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpunet_torch.config import DataConfig

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def synthetic_lm(n_train: int, n_test: int, seq_len: int = 128,
                 vocab: int = 256, seed: int = 0) -> Arrays:
    rng = np.random.default_rng(seed)
    preferred = rng.integers(0, vocab, vocab)

    def gen(n: int) -> np.ndarray:
        toks = np.empty((n, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, vocab, n)
        for t in range(1, seq_len):
            follow = rng.random(n) < 0.8
            toks[:, t] = np.where(follow, preferred[toks[:, t - 1]],
                                  rng.integers(0, vocab, n))
        return toks

    train_x, test_x = gen(n_train), gen(n_test)
    return (train_x, np.zeros(n_train, np.int32),
            test_x, np.zeros(n_test, np.int32))


def text_lm(path: str, seq_len: int, train_frac: float = 0.9) -> Arrays:
    """Byte-level LM dataset from a local file: the raw bytes ARE the
    tokens (vocab 256, no tokenizer, no downloads — works in no-egress
    environments on any text/corpus file). The stream is chunked into
    non-overlapping seq_len windows; the TAIL fraction is the test split
    (contiguous, so train/test measure held-out text, not shuffled
    leakage from the same passages)."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    n_seq = len(data) // seq_len
    if n_seq < 2:
        raise ValueError(
            f"{path!r} has {len(data)} bytes; need at least "
            f"2*seq_len = {2 * seq_len} for a train/test split")
    toks = data[:n_seq * seq_len].reshape(n_seq, seq_len).astype(np.int32)
    n_train = min(n_seq - 1, max(1, int(round(n_seq * train_frac))))
    train_x, test_x = toks[:n_train], toks[n_train:]
    return (train_x, np.zeros(len(train_x), np.int32),
            test_x, np.zeros(len(test_x), np.int32))


def text_lm_packed(path: str, seq_len: int,
                   train_frac: float = 0.9) -> Arrays:
    """Byte-level PACKED LM dataset: the file is split into documents
    on newlines, documents are greedily packed into ``seq_len`` rows
    (no document straddles a row boundary; over-long documents are
    split), and each row carries per-token SEGMENT IDS in the y slot —
    1..k for the row's documents, 0 for tail padding. Trained with the
    segment-masked attention (ops/flash.py segment_ids) and the
    packed LM step, tokens never attend — and the loss never predicts —
    across document boundaries or into padding.
    """
    with open(path, "rb") as f:
        raw = f.read()
    docs = [d for d in raw.split(b"\n") if d]
    if not docs:
        raise ValueError(f"{path!r} has no non-empty lines to pack")
    rows, segs = [], []
    cur = np.zeros(seq_len, np.int32)
    cur_seg = np.zeros(seq_len, np.int32)
    pos, seg_id = 0, 0

    def flush():
        nonlocal cur, cur_seg, pos, seg_id
        if pos:
            rows.append(cur)
            segs.append(cur_seg)
            cur = np.zeros(seq_len, np.int32)
            cur_seg = np.zeros(seq_len, np.int32)
            pos, seg_id = 0, 0

    for doc in docs:
        toks = np.frombuffer(doc, np.uint8).astype(np.int32)
        for start in range(0, len(toks), seq_len):   # split long docs
            piece = toks[start:start + seq_len]
            if pos + len(piece) > seq_len:
                flush()
            seg_id += 1
            cur[pos:pos + len(piece)] = piece
            cur_seg[pos:pos + len(piece)] = seg_id
            pos += len(piece)
    flush()
    if len(rows) < 2:
        raise ValueError(
            f"{path!r} packs into {len(rows)} row(s); need at least 2 "
            f"for a train/test split (more text or smaller --seq-len)")
    x = np.stack(rows)
    y = np.stack(segs)
    n_train = min(len(x) - 1, max(1, int(round(len(x) * train_frac))))
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def get_lm_dataset(cfg: DataConfig) -> Arrays:
    if cfg.dataset == "synthetic_lm":
        return synthetic_lm(cfg.synthetic_train_size,
                            cfg.synthetic_test_size,
                            seq_len=cfg.seq_len, vocab=cfg.vocab_size)
    if cfg.dataset == "text_lm":
        if not cfg.text_path:
            raise ValueError("dataset 'text_lm' needs a file: --text-file")
        if cfg.vocab_size < 256:
            raise ValueError(
                f"text_lm is byte-level: vocab_size must be >= 256, got "
                f"{cfg.vocab_size}")
        if cfg.pack_docs:
            return text_lm_packed(cfg.text_path, cfg.seq_len)
        return text_lm(cfg.text_path, cfg.seq_len)
    raise ValueError(f"unknown LM dataset {cfg.dataset!r}")
