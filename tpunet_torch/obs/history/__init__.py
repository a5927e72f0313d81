"""Run history: remember runs, compare runs, replay runs on one clock.

Three pieces over the telemetry the rest of ``tpunet_torch/obs`` already
emits (nothing here adds a byte to the hot path):

- ``store``       — append-only run-history index: completed run dirs
  (``metrics.jsonl``) and ``BENCH_r*.json`` artifacts digested into
  bounded per-run summaries, keyed by ``run_id`` + config
  fingerprint.
- ``compare``     — cross-run regression compare: overlapping-step
  alignment, quantile deltas judged against the DKW rank-error bounds
  from ``tpunet_torch/obs/agg/merge.py``, emitted as ``obs_regression``
  records (``python -m tpunet_torch.obs.cli.compare`` exit-codes on
  the verdict).
- ``timeline``    — unified Perfetto/chrome-trace exporter over the
  flight-recorder rings: host threads, device phases, and serve
  request lifecycles from one or more runs on one wall clock
  (``python -m tpunet_torch.obs.cli.timeline``).

``fingerprint`` supplies the config hash both joins key on
(docs/metrics_schema.md "Run identity").

Copies of ``tpunet/obs/history/`` with their imports pointed at the
port, so the card's host, which has no JAX, runs them.
"""

from __future__ import annotations

from tpunet_torch.obs.history.compare import (compare_summaries,
                                        emit_regression,
                                        quantile_verdict,
                                        stream_regressions)
from tpunet_torch.obs.history.fingerprint import (config_fingerprint,
                                            train_fingerprint)
from tpunet_torch.obs.history.store import (RunHistory, bench_entry,
                                      summarize_run)
from tpunet_torch.obs.history.timeline import build_timeline, write_trace

__all__ = [
    "RunHistory", "bench_entry", "build_timeline", "compare_summaries",
    "config_fingerprint", "emit_regression", "quantile_verdict",
    "stream_regressions", "summarize_run", "train_fingerprint",
    "write_trace",
]
