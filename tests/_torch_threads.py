"""One intra-op thread for the PyTorch port's tests (tests/test_torch_*.py).

The suite runs under pytest-xdist, several workers at once, and torch
sizes its CPU thread pool to the machine's cores in every one of them:
six workers on eight cores then run ~50 threads that spin against each
other, and a test that takes 9 s alone takes minutes. Every port test
module imports this module, which sets torch's pool to ``THREADS`` in
its process; the children the tests spawn (trainer ranks, serve and
router replicas, CLI runs) get ``OMP_NUM_THREADS`` from
:func:`child_env`, or, for children that a supervisor in the test's
process starts with the inherited environment, from
:func:`one_thread_children`. Imports no JAX, so tests/test_torch_cuda.py
keeps running on the card without it.
"""

from __future__ import annotations

import os

import torch

THREADS = 1

torch.set_num_threads(THREADS)


def child_env(base=None, **extra) -> dict:
    """A copy of ``base`` (default: this process's environment) with
    ``OMP_NUM_THREADS`` set to :data:`THREADS` and ``extra`` on top."""
    env = dict(os.environ if base is None else base)
    env["OMP_NUM_THREADS"] = str(THREADS)
    env.update(extra)
    return env


def one_thread_children(monkeypatch) -> None:
    """Set ``OMP_NUM_THREADS`` for this test, so that children spawned
    with the inherited environment use one thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(THREADS))
