"""The numbers that decide ``correct`` for a training cell.

- ``loss_gap``: the largest |program - reference| / |reference| of the
  compared steps' mean losses (``loss_gap_first``: the first step's,
  which no earlier update has moved).
- ``grad_gap``: the first step's gradient as the program's optimizer got
  it (read back from Adam's first moment after one update) against the
  reference's, by the worst leaf: |norm(program) - norm(reference)| over
  the larger of the reference's norm of that leaf and of the median
  leaf.
- ``grad_gap_median``: the same measure's median over the leaves, which
  the rounding of one small leaf does not move and a gradient of
  another batch (a part of it, or one rank's rows alone) moves in most.
- ``update_gap``: the parameters' change over the compared steps, by the
  same worst-leaf measure (``update_gap_median``: its median). Elements
  whose first reference gradient is below a thousandth of the median leaf's root-mean-square are left out
  on both sides: their gradient is nought to rounding (a bias that a
  following batch norm cancels, a key's bias under softmax), and Adam
  moves them by round-off alone, by ``lr`` in the program and by nothing
  in the reference.
"""

from __future__ import annotations

from typing import Dict, List

import torch

NEGLIGIBLE = 1e-3


def _median(values: List[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1]
                                                     + v[len(v) // 2])


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              mask: Dict[str, torch.Tensor] = None) -> Dict[str, float]:
    """{leaf: |norm(program) - norm(reference)| over the larger of the
    reference's norm of the leaf and of the median leaf}, norms taken
    over ``mask``'s elements where given."""
    norms = {}
    for k, r in ref.items():
        p = prog[k].to(r.device, torch.float64)
        r = r.to(torch.float64)
        if mask is not None:
            p, r = p[mask[k]], r[mask[k]]
        norms[k] = (float(p.norm()), float(r.norm()))
    med = _median([r for _, r in norms.values()])
    gaps = {}
    for k, (p, r) in norms.items():
        scale = max(r, med)
        gaps[k] = abs(p - r) / scale if scale > 0 else float(p > 0)
    return gaps


def _worst(gaps: Dict[str, float]) -> tuple:
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def numbers(prog: dict, ref: dict, initial: Dict[str, torch.Tensor]) -> dict:
    """``prog`` and ``ref``: ``losses`` (a list), ``grads`` (the first
    step's, by leaf) and ``params`` (after the compared steps, by leaf);
    ``initial``: the parameters before the first step."""
    n = min(len(prog["losses"]), len(ref["losses"]))
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(prog["losses"][:n], ref["losses"][:n]))
    grads = leaf_gaps(prog["grads"], ref["grads"])
    grad_gap, grad_leaf = _worst(grads)
    rms = {k: float(g.double().norm()) / max(g.numel(), 1) ** 0.5
           for k, g in ref["grads"].items()}
    floor = NEGLIGIBLE * _median(list(rms.values()))
    mask = {k: g.abs() >= floor for k, g in ref["grads"].items()}
    prog_d = {k: prog["params"][k].to(initial[k].device) - initial[k]
              for k in initial}
    ref_d = {k: ref["params"][k] - initial[k] for k in initial}
    updates = leaf_gaps(prog_d, ref_d, mask)
    update_gap, update_leaf = _worst(updates)
    left_out = sum(int((~m).sum()) for m in mask.values())
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return {"loss_gap": loss_gap, "loss_gap_first": first,
            "grad_gap": grad_gap,
            "update_gap": update_gap,
            "grad_gap_median": _median(list(grads.values())),
            "update_gap_median": _median(list(updates.values())),
            "grad_leaf": grad_leaf,
            "update_leaf": update_leaf, "left_out_elements": left_out,
            "losses": list(prog["losses"][:n]),
            "ref_losses": list(ref["losses"][:n])}
