"""Deterministic per-step randomness.

tpunet folds the global step into a root key (``step_key``,
``tpunet/utils/prng.py``); here one CPU ``torch.Generator`` per step is
seeded from (seed, global step). A resumed run therefore repeats the
same draws. The step's augmentation parameters and MobileNetV2's one
dropout mask are drawn on the CPU and moved, so they do not depend on
the device. The ViT's dropout masks (25 in ViT-B/16, up to 128 x 196 x
3072 elements each) are too large to draw on the host: their bits come
from a generator on the activations' device seeded by one draw from the
step's generator and the process's rank, so they are a function of
(seed, step, rank) on a given device, and differ between the CPU and
the card. Under data parallelism the augmentation parameters and
MobileNetV2's mask are drawn for the global batch and each rank takes
its rows, so N ranks repeat one rank's draws; a ViT with dropout above
0 does not: each rank draws its own masks.
"""

from __future__ import annotations

import numpy as np
import torch

_AUGMENT_STREAM = 0x5EED   # tpunet's step_key folds the same constant


def step_generator(seed: int, step: int) -> torch.Generator:
    """The generator of global step ``step`` of a run seeded ``seed``."""
    words = np.random.SeedSequence([seed, _AUGMENT_STREAM, step]
                                   ).generate_state(2, np.uint32)
    value = (int(words[0]) << 32 | int(words[1])) & (2**63 - 1)
    return torch.Generator().manual_seed(value)
