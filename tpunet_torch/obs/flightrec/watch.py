"""Post-mortem watcher: the process that outlives the crash.

Signal handlers can capture state but cannot be trusted to assemble a
report — after glibc heap corruption the dying process may not survive
a single ``malloc``, and SIGKILL/OOM-kill run no handlers at all. So
the flight recorder leans on the one mechanism the kernel guarantees:
this tiny sibling process holds the read end of a pipe whose write end
lives in the training process, and ``read()`` returning EOF means the
parent is gone — every death mode, no cooperation required. If the
parent did not mark a clean shutdown, the watcher assembles
``crash_report.json`` from the artifacts the parent's mmap'd rings and
faulthandler left on disk.

Launched BY FILE PATH (``python watch.py``), never as a package
module: importing ``tpunet_torch`` would drag torch in, and this process
idles next to every training run — it must stay a few-MB stdlib
process. Protocol on stdin, one command per line (the dir is the
LAST field and runs to end of line, so paths with spaces survive):

    DIR <process-index> <pid> <flightrec-dir>   watch this dir
    CLEAN                                       shut down cleanly
    ASSEMBLE                                    assemble now (tests)

One watcher serves successive recorder installs in one training
process (the parent re-points it with a new DIR line).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

if __package__:
    from tpunet_torch.obs.flightrec import report as _report
else:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import report as _report                 # type: ignore


def _owned(current: str, pidx: int, pid: int) -> bool:
    """False when meta.json says a DIFFERENT (newer) incarnation owns
    the dir: run dirs are reused across restarts, and a lingering
    watcher whose parent died mid-shutdown must not assemble a report
    over the successor's files."""
    if not pid:
        return True
    import json
    try:
        with open(_report.artifact(current, _report.META_JSON,
                                   pidx)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return True                  # no/unreadable meta: assemble anyway
    return meta.get("pid") in (None, pid)


def main(stdin: Optional[object] = None) -> int:
    stdin = stdin if stdin is not None else sys.stdin
    current = ""
    pidx = 0
    pid = 0
    for line in stdin:
        parts = line.rstrip("\r\n").split(" ", 3)
        if not parts or not parts[0]:
            continue
        if parts[0] == "DIR" and len(parts) == 4:
            try:
                pidx = int(parts[1])
                pid = int(parts[2])
            except ValueError:
                continue             # malformed: never die over one line
            current = parts[3]
        elif parts[0] == "CLEAN":
            current = ""
        elif parts[0] == "ASSEMBLE" and current:
            try:
                _report.write_report(current, pidx)
            except Exception:
                pass
    # EOF: the parent is dead. A clean parent said CLEAN (or left the
    # marker — close() does both, belt and suspenders); anything else
    # is a crash.
    if current and not _report.is_clean(current, pidx) \
            and _owned(current, pidx, pid):
        try:
            _report.write_report(current, pidx)
        except Exception:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
