"""The readings that set the limits of ``correct``, apart from the
benchmark's own runs (which give the program's readings).

For a cell and some seeds, on one card, at the cell's own sizes, this
puts computations in the program's place and reads the same numbers the
benchmark compares (``portbench.reference.compare``):

- ``program``: the program itself, as the benchmark's set-up runs it
  (its first steps through the Trainer's own call), one Trainer a seed in
  one process, which saves a process's start a seed;
- ``fp8``, the control: the reference computed in float8, the precision
  below the configuration's bfloat16;
- ``bf16``: a witness, the reference rounded to the configuration's own
  bfloat16 at the same points, which shows what the precision alone
  does to a number;
- ``half``: a fault, half of the batch left out and the mean taken over
  the rest;
- ``local``: a fault of a several-rank cell, the exchange between cards
  left out: rank 0's rows alone, with their own batch statistics and
  gradient.

A state left unchanged reads 1 on ``update_gap`` by the measure's
definition and needs no run.

    python3 portbench/control.py --workload mnv2_224.train.b128 \\
        --seeds 11,12,13 --kinds fp8,half
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
           "update_gap", "update_gap_median")
HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path
                                    if Path(p or ".").resolve() != HERE]


def readings(cfg: dict, mix: dict, seed: int, kinds, device) -> dict:
    """{kind: the compared numbers} of one seed."""
    import torch

    from portbench import traffic, weights
    from portbench.reference import compare
    from portbench.reference import train as reference

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    x, y, _, _ = traffic.dataset(mix, seed)
    spec = reference.param_spec(cfg)
    initial = weights.make(spec, seed, device)

    def steps(**kw):
        return reference.run_steps(cfg, mix, seed, x, y,
                                   {k: v.clone() for k, v in initial.items()},
                                   3, device, **kw)

    ref = steps()
    gb = mix["batch_per_rank"] * mix["ranks"]
    out = {}
    if "program" in kinds:
        out["program"] = _program(cfg, mix, seed, device, ref, initial, gb)
    plans = {"fp8": {"precision": "fp8"}, "bf16": {"precision": "bf16"},
             "half": {"rows": slice(0, gb // 2)},
             "local": {"rows": slice(0, mix["batch_per_rank"])}}
    for kind in kinds:
        if kind == "program":
            continue
        got = steps(**plans[kind])
        nums = compare.numbers(got, ref, initial)
        out[kind] = {k: nums[k] for k in NUMBERS + ("grad_leaf",
                                                     "update_leaf")}
        del got
    return out


def _program(cfg, mix, seed, device, ref, initial, gb) -> dict:
    import gc
    import shutil
    import tempfile

    import torch

    from portbench import cell
    from portbench.reference import compare

    if mix["ranks"] != 1:
        raise ValueError("the program's readings of a several-rank cell "
                         "come from the benchmark's runs")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    trainer, loop, _, _ = cell.start(cfg, mix, seed, 1, device, 0.0, {},
                                     workdir, {})
    prog = {"losses": [float(v) / gb for v in loop.loss_sums],
            "grads": loop.grads, "params": loop.params}
    trainer.close()
    del trainer, loop
    shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums = compare.numbers(prog, ref, initial)
    return {k: nums[k] for k in NUMBERS + ("grad_leaf", "update_leaf")}


def main(argv=None) -> int:
    import torch

    from portbench.run import load_cell
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--kinds", default="fp8,half")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    _, cell, cfg, mix = load_cell(args.workload)
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = readings(cfg, mix, seed, args.kinds.split(","), device)
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "seconds": time.perf_counter() - t0, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
