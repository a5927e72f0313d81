"""Non-blocking exporter core: bounded queue + background drain thread.

A copy of ``tpunet/obs/export/exporter.py`` (framework-free).

Threading model (what makes the counters safe without locks): the
training thread is the only caller of ``write``/``close``, so it is
the single writer of the ``dropped`` counter and the ``enqueued``
tally; the drain thread is the single writer of ``sent`` and
``send_errors``. Gauges mirror the drain-side tallies into the
registry with plain assignments (atomic under the GIL). Nothing is
read-modify-written from two threads.
"""

from __future__ import annotations

import queue
import threading


# Sentinel enqueued by close(): FIFO ordering guarantees every record
# written before close() drains before the thread exits — the clean
# flush-on-close ordering the tests pin down.
_CLOSE = object()


class MemoryTransport:
    """Test transport: records land in ``self.records`` in delivery
    order. ``gate`` (a ``threading.Event``) blocks delivery until set,
    simulating a wedged endpoint; ``fail_every`` raises on every Nth
    send, simulating a flaky one."""

    def __init__(self, gate: threading.Event = None, fail_every: int = 0):
        self.records: list = []
        self.gate = gate
        self.fail_every = fail_every
        self._n = 0

    def send(self, record: dict) -> None:
        if self.gate is not None:
            self.gate.wait()
        self._n += 1
        if self.fail_every and self._n % self.fail_every == 0:
            raise IOError("injected transport failure")
        self.records.append(record)


class AsyncExporter:
    """Registry sink that never blocks the caller.

    ``write`` is ``put_nowait`` + (on a full queue) one counter
    increment — O(1) host work with no syscalls, safe on the per-step
    path even when the endpoint is down. The daemon drain thread owns
    the transport; its per-record failures increment
    ``export_<name>_send_errors`` and are otherwise swallowed (a
    telemetry endpoint must never be able to kill a run).

    ``close`` enqueues a sentinel and joins with ``flush_timeout``:
    everything enqueued before close is delivered (or counted as a
    send error) before the thread exits; if the transport is so wedged
    the flush times out, the leftover queue depth is added to the
    dropped counter so the accounting identity still holds.
    """

    def __init__(self, transport, *, name: str = "sink",
                 queue_size: int = 1024, flush_timeout: float = 5.0,
                 registry=None):
        if queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        self.name = name
        self._send = getattr(transport, "send", None) or transport.write
        # Transports with a send_many (the HTTP one) get the queue
        # drained in batches: one request per backlog, not per record,
        # so a fast producer can't outrun the drain via per-request
        # latency alone.
        self._send_many = getattr(transport, "send_many", None)
        self._batch_max = 64
        self._transport = transport
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._flush_timeout = flush_timeout
        self._enqueued = 0
        self._sent = 0
        self._errors = 0
        self._closed = False
        self._abandoned = False
        # Guards the abandon/tally handoff on the close-timeout path:
        # without it a record whose send completes in the same instant
        # close() gives up could be counted both sent AND dropped.
        # Never touched by the training thread's write().
        self._acct = threading.Lock()
        if registry is not None:
            self._dropped = registry.counter(f"export_{name}_dropped")
            self._sent_gauge = registry.gauge(f"export_{name}_sent")
            self._err_gauge = registry.gauge(f"export_{name}_send_errors")
        else:
            from tpunet_torch.obs.registry import Counter, Gauge
            self._dropped = Counter()
            self._sent_gauge = Gauge()
            self._err_gauge = Gauge()
        # Host-thread registry (tpunet_torch/obs/flightrec/): the drain
        # thread flips idle (parked on the queue) / busy (sending), so
        # thread_stalled only pages on a send wedged past the budget,
        # never on an idle exporter.
        from tpunet_torch.obs.flightrec import register_thread
        self._handle = register_thread(f"export-{name}",
                                       stall_after_s=120.0)
        self._thread = threading.Thread(
            target=self._drain, name=f"tpunet-export-{name}", daemon=True)
        self._thread.start()

    # -- training-thread side -------------------------------------------

    def write(self, record: dict) -> None:
        """Registry-sink entry point; never blocks, never raises."""
        if self._closed:
            self._dropped.inc()
            return
        try:
            self._q.put_nowait(record)
            self._enqueued += 1
        except queue.Full:
            self._dropped.inc()

    def stats(self) -> dict:
        """{enqueued, sent, send_errors, dropped} — exact once closed;
        a live snapshot (drain thread still moving) before that."""
        return {
            "enqueued": self._enqueued,
            "sent": self._sent,
            "send_errors": self._errors,
            "dropped": int(self._dropped.value),
        }

    def close(self) -> None:
        """Flush and stop: records written before this call drain (in
        order) before the thread exits, bounded by ``flush_timeout``."""
        if self._closed:
            return
        self._closed = True
        try:
            self._q.put(_CLOSE, timeout=self._flush_timeout)
        except queue.Full:
            pass  # wedged transport; the daemon thread dies with us
        self._thread.join(self._flush_timeout)
        if self._thread.is_alive():
            # Flush timed out on a wedged transport: tell the drain
            # thread to discard instead of deliver (so the records we
            # now count as dropped can't ALSO be counted sent later),
            # then account for them — enqueued == sent + errors +
            # dropped stays true. The lock pairs with the drain
            # thread's tally section so the handoff is atomic.
            with self._acct:
                self._abandoned = True
                undelivered = (self._enqueued - self._sent
                               - self._errors)
            if undelivered > 0:
                self._dropped.inc(undelivered)
        tclose = getattr(self._transport, "close", None)
        if tclose is not None:
            try:
                tclose()
            except Exception:
                pass

    # -- drain-thread side ----------------------------------------------

    def _drain(self) -> None:
        while True:
            self._handle.beat("idle")
            item = self._q.get()
            self._handle.beat("busy")
            if item is _CLOSE:
                self._handle.beat("idle")
                return
            batch = [item]
            stop = False
            if self._send_many is not None:
                # Greedy batch: one request per backlog instead of per
                # record, so per-request latency can't outrun a fast
                # producer.
                while len(batch) < self._batch_max:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _CLOSE:
                        stop = True
                        break
                    batch.append(nxt)
            if not self._abandoned:
                try:
                    if self._send_many is not None:
                        self._send_many(batch)
                    else:
                        self._send(batch[0])
                    with self._acct:
                        if not self._abandoned:
                            # close() may have given up while this
                            # send was in flight and counted it as
                            # dropped; leave it there — over-delivery
                            # is fine, double-counting is not.
                            self._sent += len(batch)
                    self._sent_gauge.set(self._sent)
                except Exception:
                    with self._acct:
                        if not self._abandoned:
                            self._errors += len(batch)
                    self._err_gauge.set(self._errors)
            if stop:
                self._handle.beat("idle")
                return
