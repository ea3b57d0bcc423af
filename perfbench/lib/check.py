"""The comparison that decides ``correct``: the program's checked steps
against the plain reference's.

Four numbers, each a gap that reads 0 when the two agree:

* ``loss_gap``: the largest |program - reference| / |reference| of the
  checked steps' losses;
* ``grad_gap``: the first step's gradient as Adam got it (clipped), leaf by
  leaf: the largest |norm(program) - norm(reference)| over the larger of
  the reference's norm of that leaf and of the median leaf;
* ``omega_gap``: the same over the stages' gradient norms of the first
  step (unclipped: the square roots of Alg. 1's omegas, which weight the
  merge);
* ``update_gap``: the same over each leaf's change from the starting
  weights after the checked steps, recoveries included.  Leaves whose
  reference gradient is under a thousandth of the median leaf's are left
  out: Adam moves them by round-off alone.

Nothing here imports the program.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Mapping, Sequence, Tuple

NUMBERS = ("loss_gap", "grad_gap", "omega_gap", "update_gap")
#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the change
NOUGHT = 1e-3


def _worst(program: Mapping[str, float], reference: Mapping[str, float],
           keys: Sequence[str]) -> float:
    floor = median(reference[k] for k in keys)
    worst = 0.0
    for k in keys:
        denom = max(reference[k], floor)
        gap = abs(program[k] - reference[k]) / denom if denom > 0 else (
            0.0 if program[k] == reference[k] else math.inf)
        if not math.isfinite(program[k]):
            gap = math.inf
        worst = max(worst, gap)
    return worst


def numbers(first: dict, checked: dict, ref) -> Dict[str, float]:
    """The four gaps from the program's first step (``first``: loss, grad,
    omegas), its checked steps (``checked``: losses, moved) and the
    reference's :class:`~perfbench.lib.reftrain.Followed` with ``moved``
    added."""
    losses = list(zip([first["loss"]] + list(checked["losses"]),
                      [ref.losses[0]] + list(ref.losses)))
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                   for p, r in losses)
    keys = sorted(ref.first_grad)
    grad_gap = _worst(first["grad"], ref.first_grad, keys)
    om_p = {str(i): math.sqrt(max(w, 0.0)) if math.isfinite(w) else w
            for i, w in enumerate(first["omegas"])}
    om_r = {str(i): math.sqrt(max(w, 0.0))
            for i, w in enumerate(ref.first_omegas)}
    omega_gap = _worst(om_p, om_r, sorted(om_r))
    floor = median(ref.first_grad.values())
    moved = [k for k in keys if ref.first_grad[k] >= NOUGHT * floor]
    update_gap = _worst(checked["moved"], ref.moved, moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "omega_gap": omega_gap, "update_gap": update_gap}


def left_out(ref) -> List[str]:
    """The leaves the change leaves out, by the rule on the reference's
    gradient."""
    floor = median(ref.first_grad.values())
    return sorted(k for k, g in ref.first_grad.items() if g < NOUGHT * floor)


def judge(values: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number that has a limit finite and at most it, {name:
    {value, limit}}).  A cell leaves out of its limits a number that
    neither the control nor a planted fault lifts far enough above the
    program's readings to bound: that number is not compared."""
    unknown = set(limits) - set(NUMBERS)
    if unknown or not limits:
        raise ValueError(f"limits for {sorted(unknown)}; the numbers are "
                         f"{NUMBERS}")
    table = {k: {"value": float(values[k]), "limit": float(limits[k])}
             for k in NUMBERS if k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
