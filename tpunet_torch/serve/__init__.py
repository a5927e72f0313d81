"""Production inference serving (``python -m tpunet_torch.serve``), port
of ``tpunet/serve``:

- ``engine``    — continuous batching over a pool of KV-cache slots
  (paged by default, with the prefix cache and its spill store; int8
  pages), bucketed chunked prefill, per-slot positions and active masks,
  device-side sampling, speculative decoding;
- ``spec``      — the drafter's width, acceptance rule, npz and fit;
- ``chaos``     — serve-tier fault injection (``--chaos``);
- ``scheduler`` — bounded FIFO admission with backpressure, deadlines
  and cooperative cancellation;
- ``classify``  — the micro-batched classifier path;
- ``frontend``  — the stdlib HTTP server: ``/v1/generate`` (optionally
  streamed as ndjson), ``/v1/classify``, ``/healthz``, ``/metrics``.

SLO metrics (``serve_*`` instruments, ``obs_serve`` records) use the JAX
package's names (``docs/metrics_schema.md``).
"""

from tpunet_torch.serve.classify import ClassifyBatcher
from tpunet_torch.serve.engine import Engine, PromptTooLongError, sample_token
from tpunet_torch.serve.frontend import ServeServer
from tpunet_torch.serve.scheduler import (DrainingError, GenerateRequest,
                                          QueueFullError, RequestQueue)

__all__ = [
    "ClassifyBatcher", "DrainingError", "Engine", "GenerateRequest",
    "PromptTooLongError", "QueueFullError", "RequestQueue",
    "ServeServer", "sample_token",
]
