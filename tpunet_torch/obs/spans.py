"""Trace spans: labelled host regions for the profiler's timeline.

The port's counterpart of ``span`` in ``tpunet/obs/spans.py``:
``torch.profiler.record_function(name)`` (a region in a
``torch.profiler`` trace) plus, once CUDA is initialised in this
process, an NVTX range of the same name (Nsight's timeline). Names are
the JAX package's (``tpunet/serve_prefill``, ``tpunet/serve_decode``),
so traces of both packages read the same. ``WindowedProfiler`` comes
with ROADMAP Queue A item 7.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def span(name: str):
    """Host-side labelled region (nests freely)."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
