#!/usr/bin/env python3
"""Hold two checkouts' training runs against each other on one card.

    python3 scripts/chip_train_ab.py PARENT_ROOT CHANGE_ROOT

Runs ``chip_smoke.py``'s build, ``train`` (fused leg) and ``train (ragged
leg)`` phases of each checkout in a process of its own, in turns (parent,
change, change, parent), and prints each run's whole-run
max_memory_allocated and warm step times (steps 2-4) by leg, beside the
card's name and power limit.  Needs a CUDA device; each checkout must hold
``chip_smoke.py`` and ``src/repro_torch``.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

PHASES = ("import sys; sys.path[:0] = ['.', 'src']; import chip_smoke as c; "
          "c.device_phase(); c.build_phase(); c.train_phase(); c.train_ragged_phase()")
LEGS = {"== train\n": "fused", "== train (ragged leg)\n": "ragged"}


def run(root: Path) -> dict:
    """One checkout's phases: {leg: (peak GB, [warm step seconds])}."""
    out = subprocess.run([sys.executable, "-c", PHASES], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        raise SystemExit(f"{root}: the phases failed\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
    res, leg = {}, None
    for line in out.stdout.splitlines(keepends=True):
        leg = LEGS.get(line, leg)
        if leg is None:
            continue
        peak, steps = res.setdefault(leg, [None, []])
        m = re.match(r"step (\d+): loss .*?\), ([\d.]+) s, ", line)
        if m and int(m.group(1)) > 1:
            steps.append(float(m.group(2)))
        m = re.search(r"max_memory_allocated ([\d.]+) GB against", line)
        if m:
            res[leg][0] = float(m.group(1))
    return res


def main() -> int:
    parent, change = (Path(p).resolve() for p in sys.argv[1:3])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        for leg, (peak, steps) in run(root).items():
            print(f"{label} {leg} leg: max_memory_allocated {peak:.2f} GB; warm steps 2-4 "
                  f"{', '.join(f'{s:.3f}' for s in steps)} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
