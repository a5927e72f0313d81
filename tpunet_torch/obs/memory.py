"""Device memory gauges and the multi-process heartbeat, the port's
counterpart of ``tpunet/obs/memory.py``.

Both are *epoch-boundary* samplers: ``torch.cuda.memory_stats()`` is a
host-side query of the caching allocator (no device sync) but still a
round-trip, and the heartbeat waits on the process group's store —
neither belongs on the per-step path. The allocator counts the tensors
it holds, not the workspaces cuDNN or cuBLAS take outside it.
"""

from __future__ import annotations

import datetime
from typing import Dict, List

import torch

from tpunet_torch.parallel import dist

# How long rank 0 waits for each peer's heartbeat key before it counts
# that peer as missing.
_HEARTBEAT_WAIT = datetime.timedelta(seconds=30)


def device_memory_records(device=None) -> List[Dict]:
    """The trainer's device's memory sample: ``device`` (the CUDA
    index), ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching
    allocator's current and peak allocated bytes) and ``bytes_limit``
    (the card's total memory). A CPU device yields ``{"device": 0}``
    alone, as tpunet's CPU backend does, so the record schema is
    shape-stable across devices."""
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return [{"device": 0}]
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    rec: Dict = {"device": index}
    try:
        stats = torch.cuda.memory_stats(index)
        rec["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
        rec["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak",
                                                 0))
        rec["bytes_limit"] = int(torch.cuda.mem_get_info(index)[1])
    except Exception:
        pass
    return [rec]


def sample_memory_gauges(registry, device=None) -> List[Dict]:
    """Set ``mem_bytes_in_use`` / ``mem_peak_bytes_in_use`` gauges
    (max over local devices — the OOM-relevant figure) and return the
    per-device records for the epoch summary."""
    records = device_memory_records(device)
    in_use = [r["bytes_in_use"] for r in records if "bytes_in_use" in r]
    peak = [r["peak_bytes_in_use"] for r in records
            if "peak_bytes_in_use" in r]
    if in_use:
        registry.gauge("mem_bytes_in_use").set(max(in_use))
    if peak:
        registry.gauge("mem_peak_bytes_in_use").set(max(peak))
    return records


_HEARTBEAT_SEQ = 0


def _live_processes(tag: str) -> int:
    """Every rank sets its key for ``tag`` in the process group's store;
    rank 0 counts the keys that appear within a bounded wait each (the
    counterpart of tpunet's ``kv_live_processes``: a dead peer costs a
    timeout, never a hang in a device collective). The other ranks
    cannot see the count and report the world size."""
    import torch.distributed as tdist

    store = tdist.distributed_c10d._get_default_store()
    base = f"tpunet_hb/{tag}"
    rank, world = dist.process_index(), dist.process_count()
    store.set(f"{base}/{rank}", "1")
    if rank != 0:
        return world
    live = 0
    for i in range(world):
        try:
            store.wait([f"{base}/{i}"], _HEARTBEAT_WAIT)
            live += 1
        except Exception:
            continue
    return live


def heartbeat(registry, elapsed_s: float) -> int:
    """Coordinator-side liveness gauge: every process checks in at the
    epoch boundary; the coordinator records how many answered and
    when. At world 1 this is 1, and the process group (if any) is not
    touched. The sequence counter advances identically on every
    process (one call per epoch boundary each)."""
    global _HEARTBEAT_SEQ
    n = dist.process_count()
    if n > 1:
        _HEARTBEAT_SEQ += 1
        n = _live_processes(f"epoch/{_HEARTBEAT_SEQ}")
    registry.gauge("live_processes").set(n)
    registry.gauge("heartbeat_s").set(elapsed_s)
    return n
