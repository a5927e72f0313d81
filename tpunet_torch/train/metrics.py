"""Exact metrics as sums: a torch copy of ``tpunet/train/metrics.py``.

Every metric is a (loss_sum, correct, count) triple of sums over the
batch; they stay on the device while they are accumulated and are read
once, by :func:`summarize`, which sums them over the ranks of the
mesh's 'data' axis first (the ranks of a 'model' group hold the same
rows; the LM's also over 'seq', whose ranks count their own positions),
so every rank reads the global numbers.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpunet_torch.parallel.dist import all_reduce
from tpunet_torch.parallel.mesh import axis_group

Metrics = Dict[str, torch.Tensor]


def from_batch(loss_sum, correct, count, device=None) -> Metrics:
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)
    return {"loss_sum": f32(loss_sum), "correct": f32(correct),
            "count": f32(count)}


def zeros_metrics(device=None) -> Metrics:
    return from_batch(0.0, 0.0, 0.0, device)


def accumulate(acc: Metrics, new: Metrics) -> Metrics:
    return {k: acc[k] + new[k] for k in acc}


def summarize(acc: Metrics, axes=("data",)) -> Dict[str, float]:
    """Device scalars -> python floats {loss, accuracy, count} of the
    global batch: one all-reduce over each mesh axis of ``axes`` (the
    LM's 'seq' ranks count their own positions, so its sums take
    ``("data", "seq")``), one read from the device."""
    sums = torch.stack([acc["loss_sum"], acc["correct"], acc["count"]])
    for axis in axes:
        sums = all_reduce(sums, axis_group(axis))
    loss_sum, correct, n = sums.tolist()
    count = max(n, 1.0)
    return {"loss": loss_sum / count, "accuracy": correct / count,
            "count": n}
