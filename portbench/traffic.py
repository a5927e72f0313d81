"""The one generator of the benchmark's inputs.

A traffic mix is a JSON file under ``portbench/traffic/``, found by the
``traffic`` name of a cell in ``BENCHMARK.json``. For training it says
what the program is fed: the data set's rows (their count, shape and
classes), the batch a rank takes, the number of ranks, the augmentation
the training step applies, and how many steps set-up runs and how many
the traced run profiles. The data set is made here from ``--seed`` and
nothing else, in one bulk draw, and handed to the program whole; the
program's own loader then gathers each step's rows by its epoch order.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
KEYS = ("name", "dataset", "batch_per_rank", "ranks",
        "setup_steps", "trace_steps", "augment")


def load(name: str) -> dict:
    """The traffic mix ``name`` (``portbench/traffic/<name>.json``)."""
    mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing or mix["name"] != name:
        raise ValueError(f"traffic {name}: missing {missing} or a name "
                         f"other than the file's")
    return mix


def dataset(mix: dict, seed: int) -> Tuple[np.ndarray, ...]:
    """(train images, train labels, test images, test labels) of the mix
    from ``seed``: uint8 images [n, h, w, c] uniform over 0..255 and
    uniform class labels (int64), from numpy's PCG64 keyed on the seed."""
    d = mix["dataset"]
    if d["kind"] != "uniform_images":
        raise ValueError(f"unknown data set kind {d['kind']!r}")
    rng = np.random.Generator(np.random.PCG64([seed, 0xDA7A]))
    shape = (d["height"], d["width"], d["channels"])

    def rows(n):
        x = rng.integers(0, 256, size=(n,) + shape, dtype=np.uint8)
        y = rng.integers(0, d["classes"], size=n, dtype=np.int64)
        return x, y

    train_x, train_y = rows(d["train_rows"])
    test_x, test_y = rows(d["test_rows"])
    return train_x, train_y, test_x, test_y
