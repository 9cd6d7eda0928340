"""The comparison that decides ``correct``: readings of the program against
the plain reference, each held to its limit (``perfbench/limits/<cell>.json``).

Training: each checked step's loss (the largest absolute gap), the norm of
the first gradient as the optimizer gets it and the norm of the parameters'
change after the checked steps, both by the worst leaf: |the program's
norm - the reference's| over the larger of the reference's norm of that
leaf and the median leaf's.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both (they move under
Adam by round-off alone).  Serving: the widest gap by which the reference's
logit of a token the program chose lies below the reference's best.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping, Optional

SMALL_GRAD = 1e-3


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              leaves) -> Dict[str, float]:
    """Each leaf's |program - reference| / max(reference, median reference)."""
    med = statistics.median(reference[n] for n in leaves)
    return {n: (abs(program[n] - reference[n]) / max(reference[n], med, 1e-30)
                if math.isfinite(program[n]) else math.inf) for n in leaves}


def leaf_gap(program: Mapping[str, float], reference: Mapping[str, float],
             leaves) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(program, reference, leaves).values())


def counted_leaves(ref_grad: Mapping[str, float]):
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= SMALL_GRAD * med]


def train_readings(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference``: {"loss": [per step], "grad": {leaf:
    norm}, "change": {leaf: norm}}."""
    leaves = counted_leaves(reference["grad"])
    loss = max((abs(p - r) if math.isfinite(p) else math.inf)
               for p, r in zip(program["loss"], reference["loss"]))
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(program["grad"], reference["grad"], leaves),
            "change_gap": leaf_gap(program["change"], reference["change"], leaves)}


def judge(readings: Mapping[str, float], limits: Mapping[str, float]
          ) -> "tuple[bool, Dict[str, dict]]":
    """(every reading within its limit, {name: {"value", "limit"}})."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value: Optional[float] = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if value is None or math.isfinite(value) else str(value),
                        "limit": limit}
    return ok, checks
