"""Data parallelism of the port across cards: ``--preset distributed`` at
N ranks against 1 rank on the same global batch.

    python3 scripts/torch_dp_check.py --nproc 4              # 4 cards, NCCL
    python3 scripts/torch_dp_check.py --nproc 2 --device cpu \\
        --image-size 32 --width-mult 0.5 --dtype float32 --batch-size 8 \\
        --synthetic-size 256                                 # gloo, CPU

Runs ``torchrun --standalone --nproc-per-node N -m tpunet_torch.train
--preset distributed`` for one epoch of seeded synthetic CIFAR-10 at
``--batch-size`` a rank, then the same at 1 rank with N times that batch
(the same global batch, data order, augmentation and dropout draws),
and prints one JSON line with both epoch records (``metrics.jsonl``),
their differences and the card's name and power limit. It exits 1 when
a loss differs by more than 1e-2 relative or an accuracy by more than
0.02: bf16 steps at another batch a card take other cuDNN algorithms,
and Adam's first updates turn gradients that are rounding noise into
full steps. Full width, 224 px, bf16 and the hand-written kernels by
default, at 32 images a rank: the one-rank run holds the whole global
batch on one card (128 at 4 ranks is the ``single`` preset's batch).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-2
ACC_TOL = 0.02


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return "no nvidia-smi"
    return out.stdout.strip() if out.returncode == 0 else out.stderr.strip()


def epoch(nproc: int, batch: int, directory: Path, flags) -> dict:
    shutil.rmtree(directory, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "tpunet_torch.train",
           "--preset", "distributed", "--epochs", "1",
           "--batch-size", str(batch), "--checkpoint-dir", str(directory),
           *flags]
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=1500)
    if run.returncode != 0:
        raise SystemExit(f"{nproc} ranks exited {run.returncode}:\n"
                         f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    # The plain epoch records; the obs records share the file.
    lines = [line for line in
             (directory / "metrics.jsonl").read_text().splitlines()
             if line.strip() and '"kind"' not in line]
    if len(lines) != 1:
        raise SystemExit(f"{directory}/metrics.jsonl has {len(lines)} "
                         "epoch records, want 1 (rank 0 alone writes)")
    return dict(json.loads(lines[0]), stdout_head=run.stdout[:300])


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per rank at --nproc ranks")
    p.add_argument("--synthetic-size", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--width-mult", type=float, default=1.0)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--out", default=str(ROOT / "build" / "tpunet_torch"
                                        / "dp_check"))
    a = p.parse_args()
    flags = ["--dataset", "synthetic", "--synthetic-size",
             str(a.synthetic_size), "--device", a.device, "--image-size",
             str(a.image_size), "--width-mult", str(a.width_mult),
             "--dtype", a.dtype, "--pallas-depthwise"]
    out = Path(a.out)
    many = epoch(a.nproc, a.batch_size, out / f"w{a.nproc}", flags)
    one = epoch(1, a.batch_size * a.nproc, out / "w1", flags)
    keys = ("train_loss", "train_accuracy", "test_loss", "test_accuracy")
    diff = {k: many[k] - one[k] for k in keys}
    ok = (all(abs(diff[k]) <= LOSS_RTOL * abs(one[k])
              for k in ("train_loss", "test_loss"))
          and all(abs(diff[k]) <= ACC_TOL
                  for k in ("train_accuracy", "test_accuracy")))
    print(json.dumps({
        "ranks": a.nproc, "batch_per_rank": a.batch_size,
        "global_batch": a.batch_size * a.nproc, "device": a.device,
        "card": card(), f"world_{a.nproc}": many, "world_1": one,
        "diff": diff, "bit_equal": all(v == 0 for v in diff.values()),
        "examples_per_sec": {f"world_{a.nproc}": many["examples_per_sec"],
                             "world_1": one["examples_per_sec"]},
        "tolerance": {"loss_rel": LOSS_RTOL, "accuracy": ACC_TOL},
        "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
