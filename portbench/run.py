"""The benchmark of ``tpunet_torch`` on NVIDIA H100 cards: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload mnv2_224.train.b128 --seed 7 \\
        --seconds 30 --trace 0

The cell names a configuration (``portbench/configs/<name>.json``) and a
traffic mix (``portbench/traffic/<name>.json``); the per-layer metrics
of a ``--trace 1`` run are read by ``portbench/metrics/<name>.py``. The
last line of standard output is the run's JSON result. A cell whose
traffic has several ranks runs one process a rank, one card each: this
process is rank 0 and starts the others, with the same arguments, over
NCCL on a free local port, and prints the result.

The run needs CUDA and as many cards as the cell asks for; it exits with
another code than 0 and prints no result otherwise, and when anything it
ran loaded JAX or the JAX package. Build caches stay inside the
checkout: the port's kernels under ``build/tpunet_torch/``, torch's and
Triton's under ``build/portbench/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# The checkout's root, not this folder: the harness is the package
# ``portbench`` beside the program's package, and its module names
# (``trace``) must not shadow the standard library's.
sys.path[:] = [str(REPO)] + [p for p in sys.path
                             if Path(p or ".").resolve() not in (ROOT, REPO)]
os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "portbench"
                                         / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "portbench" / "triton")


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # One rank of a several-rank cell, started by rank 0.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    # The tests' CPU runs: no look for a card.
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def load_cell(name: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    from portbench import traffic
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((REPO / conf["file"]).read_text())
    return bench, cell, cfg, traffic.load(cell["traffic"])


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tail(log) -> str:
    log.seek(0)
    return log.read()[-4000:]


def _watch(children, logs, stop: threading.Event) -> None:
    """End the run when another rank fails: rank 0 would otherwise wait
    in a collective for it until the timeout."""
    while not stop.wait(1.0):
        for c, log in zip(children, logs):
            if c.poll() not in (None, 0):
                print(f"portbench: rank process {c.args[-1]} exited "
                      f"{c.returncode}:\n{_tail(log)}", file=sys.stderr,
                      flush=True)
                for o in children:
                    if o.poll() is None:
                        o.kill()
                os._exit(1)


def main(argv=None) -> int:
    args = _parse(argv)
    bench, cell, cfg, mix = load_cell(args.workload)
    world = mix["ranks"]
    import torch
    from portbench import cell as cell_mod
    if args.rank is not None:
        return cell_mod.run_rank(bench, cell, cfg, mix, args.seed,
                                 args.seconds, bool(args.trace), args.rank,
                                 world, args.init, args.device, T_START)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("portbench: CUDA is not available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"] or world > cell["chips"]:
            print(f"portbench: {args.workload} needs {cell['chips']} cards "
                  f"for {world} ranks; {torch.cuda.device_count()} visible",
                  file=sys.stderr)
            return 2
    init = f"tcp://localhost:{_free_port()}" if world > 1 else None
    children, logs = [], []
    for r in range(1, world):
        # A rank's standard error goes to a file, so that rank 0's last
        # lines stay the run's last lines; a failed rank's is shown.
        logs.append(tempfile.TemporaryFile(mode="w+"))
        children.append(subprocess.Popen(
            [sys.executable, str(ROOT / "run.py"), "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace), "--device",
             args.device, "--init", init, "--rank", str(r)],
            stdout=subprocess.DEVNULL, stderr=logs[-1]))
    stop = threading.Event()
    watcher = threading.Thread(target=_watch, args=(children, logs, stop),
                               daemon=True)
    watcher.start()
    try:
        rc = cell_mod.run_rank(bench, cell, cfg, mix, args.seed,
                               args.seconds, bool(args.trace), 0, world,
                               init, args.device, T_START)
    finally:
        stop.set()
        watcher.join()
        for c in children:
            try:
                c.wait(timeout=120)
            except subprocess.TimeoutExpired:
                c.kill()
                c.wait()
    for c, log in zip(children, logs):
        if c.returncode != 0:
            print(f"portbench: rank process {c.args[-1]} exited "
                  f"{c.returncode}:\n{_tail(log)}", file=sys.stderr)
        log.close()
    bad = [c.returncode for c in children if c.returncode != 0]
    return rc or (1 if bad else 0)


if __name__ == "__main__":
    sys.exit(main())
