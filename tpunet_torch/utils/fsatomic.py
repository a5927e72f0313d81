"""Shared-filesystem atomic publish: content-digest tmp + rename,
flock-guarded first-writer-wins. A copy of ``tpunet/utils/fsatomic.py``.

The commit discipline of a fleet-shared artifact writer (the prefix KV
store's spilled pages, ``tpunet_torch/serve/prefixcache/store.py``): a
multi-host fleet pointing N replicas at ONE shared directory all
computes the same entry key, so the commit must be deduplicated —
the payload is staged under its CONTENT digest (two hosts writing
concurrently never collide on the tmp name) and committed under an
``flock``-guarded exists-check: whichever host wins writes once,
every later writer sees the committed entry and returns without
touching the file. Torn-write-safe (tmp + ``os.replace``) like every
other artifact writer in the repo; on filesystems/platforms without
flock the rename commit alone still guarantees no torn entry — only
the dedup check loses its atomicity.
"""

from __future__ import annotations

import contextlib
import hashlib
import os


@contextlib.contextmanager
def commit_lock(path: str):
    """``flock`` on ``<entry>.lock`` around an exists-check + rename
    (advisory, NFS-visible where flock is supported)."""
    lock_path = path + ".lock"
    try:
        import fcntl
    except ImportError:          # non-POSIX: rename-only safety
        yield
        return
    with open(lock_path, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def publish_bytes(path: str, payload: bytes) -> bool:
    """Commit ``payload`` at ``path`` exactly once across the fleet.

    True when the entry exists on return (this writer won, or an
    earlier one did — an existing entry is NEVER rewritten: a replica
    may be reading it right now). The parent directory is created on
    demand; any OS failure propagates to the caller, who decides
    whether the artifact is best-effort.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with commit_lock(path):
        if os.path.exists(path):
            return True
        content = hashlib.sha256(payload).hexdigest()[:16]
        tmp = path + f".{content}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    return True
