"""Shared-filesystem spill/warm-start for prefix KV pages, a copy of
``tpunet/serve/prefixcache/store.py``.

One store = one directory of ``<store_digest>-<chain_digest>.pfx``
files, each a pickled dict: the chain digest, the parent's digest
(``keys.ROOT`` at depth 0), the depth, and the page's rows as host
numpy arrays, one a leaf of the engine's cache in
``KVCache.leaves()`` order (bf16 leaves as their int16 bits). The chain
digest is the same token-prefix digest the in-pool cache and the router
hash (``keys``); ``store_digest`` scopes every entry by what makes pages
interchangeable across replicas — model config, kv page geometry and
dtype, the torch and CUDA versions, the device's name — so a lever
change is a clean MISS, never stale K/V. A port store and a tpunet store
never share entries: the digests differ on purpose, as the payload's
leaf order and rounding are each package's own.

Commit discipline is ``tpunet_torch.utils.fsatomic``: content-digest
tmp + rename under a flock-guarded first-writer-wins check. N replicas
spilling the same fleet-common system prefix write it once.

``save`` is write-through at insert time and best-effort (a read-only
disk degrades to a per-replica cache, never a crash); ``load_all``
yields entries sorted by depth so a warming replica can insert each page
only after its parent landed (capacity may truncate a chain — depth
order guarantees the kept prefix is still prefix-closed).
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import pickle
from typing import Iterator, Optional

import torch

from tpunet_torch.utils import fsatomic

SUFFIX = ".pfx"


def digest(parts: object) -> str:
    """Stable 16-hex digest of a JSON-able description: sha256 of its
    sorted JSON (tpunet's ``AotProgramStore.digest``)."""
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class PrefixStore:
    def __init__(self, directory: str, store_digest: str):
        self.directory = directory
        self.store_digest = store_digest

    def _path(self, chain_digest: str) -> str:
        return os.path.join(
            self.directory,
            f"{self.store_digest}-{chain_digest}{SUFFIX}")

    def exists(self, chain_digest: str) -> bool:
        return os.path.exists(self._path(chain_digest))

    def save(self, chain_digest: str, parent_digest: str, depth: int,
             rows: list) -> bool:
        """Publish one page's rows (host numpy arrays in the engine's leaf
        order). First writer wins; an existing entry is never rewritten.
        False on any OS failure."""
        payload = pickle.dumps({
            "digest": chain_digest,
            "parent": parent_digest,
            "depth": int(depth),
            "rows": rows,
        })
        try:
            return fsatomic.publish_bytes(self._path(chain_digest),
                                          payload)
        except OSError:
            return False

    def load_all(self, limit: Optional[int] = None) -> Iterator[dict]:
        """Entries for THIS store digest, shallowest first (parents
        before children), corrupt/foreign files skipped. ``limit`` bounds
        how many are even read — warm-start is capacity-bound anyway."""
        pattern = os.path.join(self.directory,
                               self.store_digest + "-*" + SUFFIX)
        entries = []
        for path in sorted(glob.glob(pattern)):
            try:
                with open(path, "rb") as f:
                    entry = pickle.load(f)
                entries.append(entry)
            except Exception:  # noqa: BLE001 — torn/foreign file:
                continue       # warm-start is best-effort.
        entries.sort(key=lambda e: int(e.get("depth", 0)))
        if limit is not None:
            entries = entries[:limit]
        return iter(entries)


def build_prefix_store(directory: str, model_cfg, serve_cfg,
                       device="cuda") -> PrefixStore:
    """A store scoped by everything that makes a spilled page safe to map
    into THIS engine's pool: the full model config, the kv page geometry
    and dtype, and the runtime (the torch and CUDA versions and the name
    of ``device``'s card, ``cpu`` on the CPU — quantization rounding may
    differ across devices)."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    store_digest = digest({
        "model": dataclasses.asdict(model_cfg),
        "kv_page_tokens": serve_cfg.kv_page_tokens,
        "kv_dtype": serve_cfg.kv_dtype,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": name,
    })
    return PrefixStore(directory, store_digest)
