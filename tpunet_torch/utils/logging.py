"""Rank-0 logging with the reference's epoch-line format: a copy of
``tpunet/utils/logging.py`` without JAX.

The reference prints one line per epoch from rank 0 only
(cifar10_mpi_mobilenet_224.py:229-236), captured by SLURM stdout
redirection. Serial format (cifar10_128_gpu_27326.out:30):

    Epoch 1/20 Time: 570.94s Train Loss: 0.5879 Train Acc: 0.8007 \
Test Loss: 0.2834 Test Acc: 0.9027

We replicate that format exactly so runs are directly comparable with the
reference's published logs. Accuracy is always over the whole test set,
so the serial field names are used.
"""

from __future__ import annotations

import json
import os
import sys

from tpunet_torch.parallel.dist import process_index


def is_coordinator() -> bool:
    """True on the process allowed to do I/O (reference rank==0 guards):
    rank 0, and the only process of a run without a process group."""
    return process_index() == 0


def log0(*args, **kwargs) -> None:
    """Print from the coordinator process only; flush for SLURM-style logs."""
    if is_coordinator():
        print(*args, **kwargs)
        sys.stdout.flush()


def epoch_line(epoch: int, epochs: int, seconds: float, train_loss: float,
               train_acc: float, test_loss: float, test_acc: float) -> str:
    return (
        f"Epoch {epoch}/{epochs} Time: {seconds:.2f}s "
        f"Train Loss: {train_loss:.4f} Train Acc: {train_acc:.4f} "
        f"Test Loss: {test_loss:.4f} Test Acc: {test_acc:.4f}"
    )


def summary_lines(best_acc: float, total_seconds: float) -> list[str]:
    """Reference end-of-run lines (cifar10_128_gpu_27326.out:51-52)."""
    return [
        f"Best test accuracy: {best_acc:.4f}",
        f"Total training time: {total_seconds:.2f}s ({total_seconds / 60:.2f} min)",
    ]


class MetricsLogger:
    """Machine-readable observability: one JSON line per epoch, appended
    to ``<dir>/metrics.jsonl`` by the coordinator process. The reference
    persists metrics only as SLURM stdout redirection of the epoch lines
    (cifar10_gpu_parallel.sh:8-9); this is the structured upgrade —
    append-mode + per-line flush keeps it crash/preemption-safe."""

    def __init__(self, directory: str, resume: bool = False):
        self._path = None
        if is_coordinator():
            os.makedirs(directory, exist_ok=True)
            self._path = os.path.join(directory, "metrics.jsonl")
            if not resume and os.path.exists(self._path):
                # Fresh run into a reused directory: truncate so the
                # epoch sequence in the file belongs to one run.
                open(self._path, "w").close()

    def log(self, record: dict) -> None:
        if self._path is None:
            return
        with open(self._path, "a") as f:
            # ONE write of the full line: a crash can truncate the last
            # record but never interleave two (append-mode writes of a
            # single buffer are atomic for sane line sizes).
            f.write(json.dumps(record) + "\n")

    @classmethod
    def tail_records(cls, path: str, offset: int = 0) -> tuple:
        """Incremental read for live consumers: parse complete records
        appended since ``offset`` and return
        ``(records, new_offset, reset)``.

        The trailing partial line (a write in flight, or a torn write
        after a crash) is NOT consumed — the returned offset points at
        its start, so the next poll re-reads it once it is complete.
        A file that shrank below ``offset`` (fresh run truncated it)
        restarts from the beginning and reports ``reset=True`` so the
        caller can discard state derived from the old run's records —
        the check lives HERE, on the same stat the read uses, so no
        caller-side check can race it. A malformed *complete* line is
        skipped, not fatal: a live dashboard must outlive one bad
        record."""
        import json
        import os as _os
        records = []
        reset = False
        try:
            size = _os.path.getsize(path)
        except OSError:
            return records, 0, offset > 0
        if size < offset:
            offset = 0          # truncated underneath us: new run
            reset = True
        if size == offset:
            return records, offset, reset
        with open(path, "rb") as f:
            f.seek(offset)
            chunk = f.read()
        end = chunk.rfind(b"\n")
        if end < 0:
            return records, offset, reset   # only a partial line so far
        for line in chunk[:end].splitlines():
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return records, offset + end + 1, reset

    @classmethod
    def read_records(cls, path: str) -> list:
        """Parse a ``metrics.jsonl`` back into dicts, tolerating a
        truncated trailing line (the crash/preemption artifact the
        append-per-record format can leave). A malformed line anywhere
        *else* is real corruption and raises."""
        import json
        records = []
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn trailing write: drop it
                raise ValueError(
                    f"{path}:{i + 1}: malformed record mid-file (only "
                    f"the final line may be truncated)")
        return records
