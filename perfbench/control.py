"""The control and the planted faults of a training cell, read on the chip.

  python3 perfbench/control.py --workload <name> --seeds 11,12,13

For each seed it prints one JSON line with the numbers the check compares,
as read from:

* ``program``: the program as a benchmark run reads it (its first three
  steps);
* ``control``: the plain reference put in the program's place and computed
  one precision below the configuration's bf16: every matrix product's
  operands rounded to fp8 e4m3 (``reference/common.py::Prec``);
* ``half_batch``: a fault planted in the reference put in the program's
  place, half of the batch left out (the mean taken over the other half).
  A step that returns its state unchanged reads exactly 1 on the change's
  gap (the program's change is 0) and needs no run.

The benchmark's own runs never run this.  Limits in ``limits/`` are set
from its readings and the program's over a dozen seeds or more.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

from perfbench import check, run  # noqa: E402


def train_seed(cell, drv) -> dict:
    import torch

    from perfbench.reference.common import Prec
    B = int(cell.mix["batch"])
    cell.feed = drv.generator.train_feed(cell.mix, cell.spec["vocab_size"], cell.seed,
                                         0.0, drv.WARM)
    trainer, state = drv.build(cell)
    state, prog = drv.warm(trainer, state, cell)
    del trainer, state
    drv._free()
    chunks = prog["chunks"]
    ref = drv.reference_readings(cell, chunks, Prec("fp32"))
    drv._free()
    ctl = drv.reference_readings(cell, chunks, Prec("fp8"))
    drv._free()
    half = drv.reference_readings(cell, chunks, Prec("fp32"), rows=slice(0, B // 2))
    drv._free()
    leaves = {k: {"grad": v["grad_norms"], "delta": v["delta_norms"], "loss": v["loss"]}
              for k, v in (("program", prog), ("reference", ref), ("control", ctl),
                           ("half_batch", half))}
    return {"leaves": [path for path, *_ in cell.arch.plan(cell.spec)], "readings": leaves,
            "program": check.train_gaps(prog, ref), "control": check.train_gaps(ctl, ref),
            "half_batch": check.train_gaps(half, ref), "chunks": chunks,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if torch.cuda.is_available() else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    run._environment()
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = run.Cell(bench, args.workload, seed, 0.0, False)
        cell.program_config()
        drv = cell.driver()
        print(json.dumps({"workload": cell.name, "seed": seed, **train_seed(cell, drv)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
