"""One rank of the port's multi-process tests of mixup and the agreed stop
(tests/test_torch_mixup.py, tests/test_torch_preemption.py).

    python tests/_torch_item2b_worker.py DIR WORLD RANK CASE

joins a gloo process group of WORLD ranks through a file store in DIR
and runs CASE, saving what it computed to ``DIR/{CASE}_w{WORLD}_rank{RANK}.pt``:

- ``mix``: ``make_mix`` (mixup, then CutMix) on this rank's rows of the
  seeded global batch in ``DIR/mix_inputs.pt``, at the generator of
  step 3: the mixed rows, the partner labels, lam and the collectives
  it issued;
- ``stop``: ``python -m tpunet_torch.train --preset distributed`` (the
  CLI in this process) for 2 epochs, with SIGTERM sent to rank 1 inside
  its second step: the exit code and where each rank stopped;
- ``halt``: the same run with ``--halt-on-unhealthy`` and a fatal alert
  (a non-finite loss) on rank 1 in its second step instead.

Imports no JAX and nothing of the tpunet package.
"""

from __future__ import annotations

import os
import signal
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# Agree on a stop at every step: the epochs here are 3 steps long.
os.environ["TPUNET_STOP_POLL_STEPS"] = "1"

from tpunet_torch.config import DataConfig  # noqa: E402
from tpunet_torch.data.augment import make_mix  # noqa: E402
from tpunet_torch.parallel import dist  # noqa: E402
from tpunet_torch.train import __main__ as cli  # noqa: E402
from tpunet_torch.train import loop  # noqa: E402
from tpunet_torch.utils.prng import step_generator  # noqa: E402

# 48 synthetic images at 32 px, 16 a global step: 3 steps an epoch.
CLI_FLAGS = ["--preset", "distributed", "--dataset", "synthetic",
             "--synthetic-size", "48", "--image-size", "32",
             "--batch-size", "8", "--width-mult", "0.5", "--dtype",
             "float32", "--epochs", "2", "--device", "cpu",
             "--no-download", "--seed", "1"]


def mix_case(d: str, world: int, rank: int) -> dict:
    inputs = torch.load(os.path.join(d, "mix_inputs.pt"))
    x, y = inputs["images"], inputs["labels"]
    n = x.shape[0] // world
    rows = slice(n * rank, n * (rank + 1))
    out = {}
    for name, kw in (("mixup", dict(mixup_alpha=0.4)),
                     ("cutmix", dict(cutmix_alpha=1.0))):
        mix = make_mix(DataConfig(dataset="synthetic", **kw))
        calls = dist.fetch_rows.calls
        xm, yb, lam = mix(step_generator(0, 3), x[rows], y[rows])
        out[name] = {"images": xm, "labels_b": yb, "lam": lam,
                     "fetches": dist.fetch_rows.calls - calls}
    return out


def cli_case(d: str, rank: int, case: str) -> dict:
    trainers = []
    real_init, real_step = loop.Trainer.__init__, loop.Trainer._step

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        trainers.append(self)

    def step(self, bx, by, gen):
        m = real_step(self, bx, by, gen)
        if rank == 1 and self.state.global_step == 2:
            if case == "stop":
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                self.obs.observe_loss(self.state.global_step,
                                      float("nan"))
        return m

    loop.Trainer.__init__, loop.Trainer._step = init, step
    flags = CLI_FLAGS + ["--checkpoint-dir", os.path.join(d, f"ck_{case}")]
    if case == "halt":
        flags.append("--halt-on-unhealthy")
    rc = cli.main(flags)
    t = trainers[0]
    return {"rc": rc, "step": t.state.global_step,
            "start_epoch": t.start_epoch, "history": t.history,
            "requested": t.guard.requested}


def main() -> int:
    d, world, rank, case = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    dist.initialize_distributed(
        init_method="file://" + os.path.join(d, f"store_{case}_{world}"),
        world_size=world, rank=rank, device="cpu")
    try:
        if case == "mix":
            out = mix_case(d, world, rank)
        else:
            out = cli_case(d, rank, case)
    finally:
        dist.destroy()
    torch.save(out, os.path.join(d, f"{case}_w{world}_rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
