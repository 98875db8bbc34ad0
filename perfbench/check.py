"""The comparisons that decide ``correct``, and the cells' limits.

Training (three steps from the same weights on the same rows): the first
step's loss, the per-leaf norm of the first gradient, and the per-leaf
norm of the parameters' change after the three steps.  A leaf's gap is the
distance between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger;
the numbers compared are the worst leaf's.  Beside them, the first
gradient's relative error over a seeded sample of each leaf's elements
(``grad_err``): unbiased rounding noise barely moves a norm, so only an
error of the elements themselves tells a lower precision from the
configuration's.  The later steps' losses are not compared: the first
AdamW step moves every weight by about lr, the loss jumps, and steps 2-3
read as far apart in sound runs as in the control (PERF.md).  Leaves
whose reference gradient is under a thousandth of the median leaf's (a
router bias that no loss term reaches) move by weight decay and round-off
alone and are left out by that rule.

Each cell's limits are in ``limits/<workload>.json``: {"<number>": limit}.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

HERE = Path(__file__).resolve().parent
EXCLUDE_BELOW = 1e-3          # of the median leaf's reference gradient


def load_limits(workload: str, root: Path = HERE) -> dict:
    path = root / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def _leaf_gaps(prog: list, ref: list, keep: list) -> list:
    """Per kept leaf, |program - reference| over the larger of the
    reference's norm and the median kept leaf's."""
    med = statistics.median([r for r, k in zip(ref, keep) if k])
    return [abs(p - r) / max(r, med, 1e-30) for p, r, k in zip(prog, ref, keep) if k]


def train_gaps(prog: dict, ref: dict) -> dict:
    """The training numbers of two sets of readings, each {"loss": [per
    step], "grad_norms": [per leaf], "delta_norms": [per leaf]}:
    ``loss_gap`` the first step's loss (relative), ``grad_gap`` the worst
    leaf's first gradient, ``grad_gap_mean`` the mean over the leaves of
    that gap, ``delta_gap`` the worst leaf's change over the steps."""
    med = statistics.median(ref["grad_norms"])
    keep = [g >= EXCLUDE_BELOW * med for g in ref["grad_norms"]]
    diff = sum(float((p - r).double().pow(2).sum())
               for p, r, k in zip(prog["grad_sample"], ref["grad_sample"], keep) if k)
    norm = sum(float(r.double().pow(2).sum())
               for r, k in zip(ref["grad_sample"], keep) if k)
    return {"loss_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
            "grad_gap": max(_leaf_gaps(prog["grad_norms"], ref["grad_norms"], keep)),
            "grad_err": (diff / norm) ** 0.5,
            "delta_gap": max(_leaf_gaps(prog["delta_norms"], ref["delta_norms"], keep))}


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) -- every number at or under
    its limit; a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
