"""StatsD/UDP transport: one gauge line per numeric record field.

A copy of ``tpunet/obs/export/statsd.py`` (framework-free).

UDP is the right substrate for per-step telemetry — fire-and-forget,
no connection state, a dead collector costs one syscall per datagram.
Records flatten to the classic line protocol::

    tpunet.obs_epoch.step_time_p50_s:0.0123|g

Lines are packed into MTU-sized datagrams (statsd servers split on
newline). The endpoint is resolved once at construction so a typo'd
hostname fails loudly at setup instead of doing DNS per datagram on
the drain thread.
"""

from __future__ import annotations

import math
import socket

# Conservative payload bound: fits the common 1500-byte Ethernet MTU
# with IP+UDP headers to spare (the statsd reference uses 1432).
_MTU_PAYLOAD = 1400


def _num(val) -> str:
    """Plain decimal rendering — statsd parsers reject the scientific
    notation %g would emit for values like device-memory byte counts."""
    if isinstance(val, int):
        return str(val)
    if val == int(val) and abs(val) < 1e15:
        return str(int(val))
    return f"{val:.6f}".rstrip("0").rstrip(".")


# Identity fields ride as name tags, not gauges: a fleet collector
# needs to know WHICH run a gauge line belongs to, and statsd's only
# record-shaped channel is the dogstatsd tag suffix.
_TAG_FIELDS = ("run_id", "process_index", "host")


def _tag_value(val) -> str:
    """Tag values must not carry the protocol's delimiters."""
    return str(val).replace("|", "_").replace("#", "_").replace(",", "_")


def record_to_lines(record: dict, prefix: str = "tpunet") -> list:
    """Flatten a record's numeric scalar fields to statsd gauge lines;
    nested/str/bool fields are skipped (UDP metrics carry numbers, the
    full record shape belongs to the jsonl/HTTP paths). The identity
    stamp (run_id/process_index/host) becomes a dogstatsd-style tag
    suffix ``|#run_id:...,process_index:...,host:...`` on every line
    instead of a gauge, so multi-run collectors can split streams."""
    kind = record.get("kind", "record")
    tags = ",".join(f"{k}:{_tag_value(record[k])}"
                    for k in _TAG_FIELDS if record.get(k) is not None)
    suffix = f"|#{tags}" if tags else ""
    lines = []
    for key, val in record.items():
        if key == "kind" or key in _TAG_FIELDS or isinstance(val, bool):
            continue
        if isinstance(val, int) or (isinstance(val, float)
                                    and math.isfinite(val)):
            lines.append(f"{prefix}.{kind}.{key}:{_num(val)}|g{suffix}")
    return lines


class StatsdTransport:
    def __init__(self, host: str, port: int, prefix: str = "tpunet"):
        self.prefix = prefix
        # Resolve now (raises on a bad name); keep the packed sockaddr.
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_DGRAM)
        family, _, _, _, self._addr = infos[0]
        self._sock = socket.socket(family, socket.SOCK_DGRAM)

    def send(self, record: dict) -> None:
        lines = record_to_lines(record, self.prefix)
        if not lines:
            return
        batch: list = []
        size = 0
        for line in lines:
            n = len(line) + 1
            if batch and size + n > _MTU_PAYLOAD:
                self._sock.sendto("\n".join(batch).encode(), self._addr)
                batch, size = [], 0
            batch.append(line)
            size += n
        if batch:
            self._sock.sendto("\n".join(batch).encode(), self._addr)

    def close(self) -> None:
        self._sock.close()
