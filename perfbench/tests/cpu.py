"""A cell resolved from ``BENCHMARK.json`` but run on the CPU at the
program's reduced size (``ModelConfig.reduced()`` with the fields the
configuration file sets, fp32), with the mix's sizes cut to what a test
can hold."""

import hashlib
import json
from pathlib import Path

import torch

from perfbench import run

SMALL_TRAIN = {"batch": 4, "seq_len": 128}

def cpu_cell(workload: str, seed: int = 1234567891, seconds: float = 2.0,
             bench=None, root=run.HERE) -> run.Cell:
    torch.set_num_threads(4)
    bench = bench or json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = run.Cell(bench, workload, seed, seconds, False, root=root)
    from repro_torch.configs import get_config
    port = cell.config["port"]
    pc = get_config(port["arch"]).reduced()
    pc = run.port_config(pc, {**port, "num_layers": pc.num_layers})
    cell.pcfg, cell.spec = pc, cell.arch.spec_from_port(pc)
    cell.device, cell.dtype = "cpu", torch.float32
    cell.mix = {**cell.mix, **SMALL_TRAIN}
    return cell


def run_cell(cell) -> dict:
    """The driver's record for one CPU run, and ``correct`` under the
    cell's own limits."""
    from perfbench import check
    from perfbench.trace import Window
    out = cell.driver().run(cell, Window(False))
    out["correct"] = check.judge(out["readings"], cell.limits)[0]
    return out


def digest(root: Path) -> dict:
    """{relative path: sha256} of every file under ``root`` (bytecode aside)."""
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}
