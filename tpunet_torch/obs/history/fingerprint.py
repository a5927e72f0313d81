"""Config fingerprint: the join key that makes two runs comparable.

A copy of ``tpunet/obs/history/fingerprint.py`` (framework-free). The
port's ``TrainConfig`` has no mesh, so ``train_fingerprint`` hashes an
empty one: a port run and a tpunet run never share a fingerprint group,
since their config field sets differ.

A cross-run comparison is only meaningful between runs of the SAME
workload — same model, data shape, optimizer, mesh. Nothing in a
record stream says so; run_id only names one run. The fingerprint is a
stable short hash of the compute-relevant config, stamped into the run
identity (docs/metrics_schema.md "Run identity") and into bench.py's
BENCH records, so the history store can (a) group runs that are
apples-to-apples and (b) join bench rounds to the training config that
produced them.

Stability contract: the hash is over a canonical JSON rendering
(sorted keys, no whitespace variance) of a *selected* sub-config —
fields that change the computation. Bookkeeping knobs (checkpoint
directory, run_id, telemetry endpoints, log cadence) are excluded on
purpose: re-running the same training job with a different dashboard
attached must not change its fingerprint.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

#: Hex digest length. 12 hex chars = 48 bits: collision-free for any
#: plausible number of distinct configs in one history store.
DIGEST_LEN = 12


def _canonical(obj: Any) -> Any:
    """JSON-able canonical form: dataclasses -> sorted dicts, tuples ->
    lists, everything else passed through json's own type checks."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _canonical(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    return obj


def config_fingerprint(obj: Any) -> str:
    """Stable short hash of any JSON-able / dataclass config value."""
    blob = json.dumps(_canonical(obj), sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:DIGEST_LEN]


def train_fingerprint(cfg: Any) -> str:
    """Fingerprint of a ``TrainConfig``: the compute-relevant
    sub-configs only (model / data / optim / mesh + epoch count).
    Checkpoint paths, obs/export endpoints, and profiling knobs are
    deliberately excluded — they do not change what the run computes,
    so they must not break run-to-run comparability."""
    return config_fingerprint({
        "model": _canonical(cfg.model),
        "data": _canonical(cfg.data),
        "optim": _canonical(cfg.optim),
        "mesh": {},
        "epochs": getattr(cfg, "epochs", None),
    })
