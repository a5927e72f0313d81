"""Trace spans and windowed profiling, the port's counterpart of
``tpunet/obs/spans.py``.

A span is ``torch.profiler.record_function(name)`` (a region in a
``torch.profiler`` trace) plus, once CUDA is initialised in this
process, an NVTX range of the same name (Nsight's timeline). Names are
the JAX package's (``tpunet/data_wait``, ``tpunet/eval``,
``tpunet/serve_decode``, ``train`` for a step), so traces of both
packages read the same. ``WindowedProfiler`` captures a
``torch.profiler`` trace for exactly the configured step window
[start, start+num), with ``sync`` fences (``torch.cuda.synchronize``)
at the two window edges ONLY — asynchronous launches mean work queued
before the window would otherwise bleed into it, and work launched
inside the window would escape it.
"""

from __future__ import annotations

import contextlib

import torch

# Reusable no-op span for the disabled path (nullcontext is documented
# reentrant and reusable — nothing allocated per use).
NULL_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def span(name: str, args=None):
    """Host-side labelled region (nests freely); ``args`` (a string)
    rides on the profiler event."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name, args):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def step_span(step: int, name: str = "train"):
    """Per-step region (the counterpart of ``StepTraceAnnotation``):
    named ``train``, carrying the step number in its event's args."""
    return span(name, str(step))


class WindowedProfiler:
    """Capture a ``torch.profiler`` trace for steps [start, start+num).

    ``num_steps == 0`` with a non-empty ``profile_dir`` keeps the
    whole-run semantics (start at the first step, stop at ``close()``).
    ``on_step`` is called before each step's launch with the global
    step number and a ``sync`` callable (``torch.cuda.synchronize`` on
    the trainer's card); the sync runs at window edges only, never on
    interior steps. The trace records host activity, and the card's
    kernels when ``cuda``; it lands in ``profile_dir`` as
    ``rank{r}.<time>.pt.trace.json`` (TensorBoard's profiler plugin or
    Perfetto read it).
    """

    def __init__(self, profile_dir: str, start_step: int = 0,
                 num_steps: int = 0, cuda: bool = False, rank: int = 0):
        if start_step < 0 or num_steps < 0:
            raise ValueError(
                f"profile window must be non-negative, got start_step="
                f"{start_step} num_steps={num_steps}")
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.num_steps = num_steps
        self.cuda = cuda
        self.rank = rank
        self.running = False
        self._done = not bool(profile_dir)
        self._prof = None

    @property
    def active(self) -> bool:
        """True while this profiler may still start or stop a trace
        (the loop skips the per-step check entirely once False)."""
        return not self._done or self.running

    def on_step(self, step: int, sync=None) -> None:
        if self._done and not self.running:
            return
        if self.running:
            if (self.num_steps
                    and step >= self.start_step + self.num_steps):
                self._stop(sync)
            return
        if step >= self.start_step:
            if self.num_steps and step >= self.start_step + self.num_steps:
                # The run resumed past the window (or the window fell
                # inside a skipped epoch): never trace.
                self._done = True
                return
            if sync is not None:
                sync()  # fence: pre-window launches complete outside
            self._start()
            self.running = True

    def _start(self) -> None:
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(
                self.profile_dir, worker_name=f"rank{self.rank}"))
        self._prof.start()

    def _stop(self, sync=None) -> None:
        if sync is not None:
            sync()  # fence: in-window launches complete inside
        prof, self._prof = self._prof, None
        self.running = False
        self._done = True
        prof.stop()

    def close(self, sync=None) -> None:
        """End-of-run: flush a still-open (whole-run or truncated)
        window."""
        if self.running:
            self._stop(sync)
        self._done = True
