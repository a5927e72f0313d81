"""Micro-batched classifier path, port of ``tpunet/serve/classify.py``.

Concurrent requests are held for at most ``window_ms`` and run as ONE
batched forward padded to a fixed ``batch_max``: padding rows are zero
images whose outputs are dropped, so the model always sees one batch
shape whatever the arrival pattern. Preprocessing (the Predictor's
exact resize + normalize) is issued by the calling thread on the
predictor's device, as ``Predictor.predict_probs`` does it and as the
JAX batcher resizes on its default device; the single worker thread
runs the batched forward, registered with the flight recorder's
host-thread registry: a batched forward wedged on the device past 120 s
reads as stalled, an idle queue wait does not.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from tpunet_torch.infer.predict import preprocess, to_uint8
from tpunet_torch.obs import flightrec
from tpunet_torch.obs.registry import Registry


class _Pending:
    __slots__ = ("image", "event", "probs", "error")

    def __init__(self, image: torch.Tensor):
        self.image = image
        self.event = threading.Event()
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[str] = None


class ClassifyBatcher:
    """Wraps a ``Predictor`` with a batching window.

    ``submit(image)`` blocks the calling (HTTP handler) thread until its
    probs are ready; the single worker thread runs every forward.
    """

    def __init__(self, predictor, *, batch_max: int = 8,
                 window_ms: float = 2.0, registry=None):
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        self.predictor = predictor
        self.batch_max = int(batch_max)
        self.window_s = float(window_ms) / 1000.0
        self.registry = registry if registry is not None else Registry()
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._size = predictor.data_cfg.image_size
        self._thread_handle = flightrec.register_thread(
            "serve-classify", stall_after_s=120.0)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpunet-serve-classify")
        self._thread.start()

    @property
    def healthy(self) -> bool:
        return self._thread.is_alive()

    def submit(self, image, timeout: float = 30.0) -> np.ndarray:
        """Classify one image (uint8 HWC array or PIL); returns class
        probabilities. Blocks until the batched forward that includes
        this image completes."""
        item = _Pending(preprocess(to_uint8(image), self.predictor.data_cfg,
                                   self.predictor.device))
        self._q.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("classify batch did not complete "
                               f"within {timeout}s")
        if item.error is not None:
            raise RuntimeError(item.error)
        return item.probs

    def _run(self) -> None:
        reg = self.registry
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.batch_max:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            t0 = time.perf_counter()
            self._thread_handle.beat("busy")
            try:
                x = torch.zeros((self.batch_max, self._size, self._size, 3),
                                device=self.predictor.device)
                for i, item in enumerate(batch):
                    x[i] = item.image
                probs = self.predictor.forward(x).cpu().numpy()
                for i, item in enumerate(batch):
                    item.probs = probs[i]
                    item.event.set()
            except Exception as e:  # noqa: BLE001 — fail the batch, not
                # the worker: the next window must still serve.
                for item in batch:
                    item.error = f"{type(e).__name__}: {e}"
                    item.event.set()
            self._thread_handle.beat("idle")
            reg.counter("serve_classify_requests_total").inc(len(batch))
            reg.counter("serve_classify_batches_total").inc()
            reg.histogram("serve_classify_batch_size").observe(len(batch))
            reg.histogram("serve_classify_s").observe(
                time.perf_counter() - t0)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
