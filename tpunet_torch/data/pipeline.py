"""Per-host batch iteration: a framework-free copy of
``tpunet/data/pipeline.py``.

Each host holds the full dataset in RAM and slices its contiguous shard
of a deterministic global permutation seeded by (seed, epoch), so the
index order is bit-equal to tpunet's for every (seed, epoch). The train
remainder is dropped; evaluation pads the final batch with masked
examples so test metrics are exact. Rows are images (uint8) or token
rows (int32 [T]); labels are per-example scalars or, for packed token
rows, per-token segment ids [T], and padding keeps their trailing shape.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """Same permutation on every host (counter-based PRNG keyed on inputs)."""
    bits = np.random.Generator(np.random.Philox(key=[seed, epoch]))
    return bits.permutation(n)


def steps_per_epoch(n: int, global_batch: int) -> int:
    return n // global_batch


def host_index_sequence(n: int, *, global_batch: int, seed: int, epoch: int,
                        process_index: int = 0,
                        process_count: int = 1) -> np.ndarray:
    """This host's full index order for an epoch (concatenated per-step
    slices of the global permutation)."""
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes")
    local = global_batch // process_count
    perm = _epoch_permutation(n, seed, epoch)
    n_steps = steps_per_epoch(n, global_batch)
    # Step s gives this host rows [s*gb + pi*local, s*gb + (pi+1)*local):
    # i.e. column `process_index` of the (steps, processes, local) view.
    return (perm[:n_steps * global_batch]
            .reshape(n_steps, process_count, local)[:, process_index]
            .reshape(-1))


def train_batches(
    images: np.ndarray,
    labels: np.ndarray,
    *,
    global_batch: int,
    seed: int,
    epoch: int,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield this host's (images_u8, labels) slices of each global batch."""
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes")
    local = global_batch // process_count
    perm = _epoch_permutation(len(images), seed, epoch)
    n_steps = steps_per_epoch(len(images), global_batch)
    for s in range(n_steps):
        start = s * global_batch + process_index * local
        idx = perm[start:start + local]
        yield images[idx], labels[idx]


def eval_batches(
    images: np.ndarray,
    labels: np.ndarray,
    *,
    global_batch: int,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (images, labels, mask) covering the eval set exactly once.

    The final batch is zero-padded; ``mask`` is 1.0 for real examples and
    0.0 for padding, so reductions weighted by mask give exact metrics.
    """
    if global_batch % process_count:
        raise ValueError("global eval batch not divisible by process count")
    local = global_batch // process_count
    n = len(images)
    n_steps = (n + global_batch - 1) // global_batch
    for s in range(n_steps):
        start = s * global_batch + process_index * local
        stop = min(start + local, n) if start < n else start
        count = max(0, stop - start)
        x = np.zeros((local,) + images.shape[1:], dtype=images.dtype)
        y = np.zeros((local,) + labels.shape[1:], dtype=labels.dtype)
        m = np.zeros((local,), dtype=np.float32)
        # labels may be per-example scalars or per-token rows (packed LM
        # segment ids): padded with whatever trailing shape they have.
        if count:
            x[:count] = images[start:stop]
            y[:count] = labels[start:stop]
            m[:count] = 1.0
        yield x, y, m
