"""Run one benchmark cell once and print its result line.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
file and a traffic mix (``perfbench/traffic/<traffic>.json``, read by
``perfbench/generator.py``).  The configuration file
(``perfbench/configs/<config>.json``: the published keys as run, the
program's registry entry with its depth and the fields the file sets)
names the files that read it: its architecture file
(``perfbench/arch/<arch>.py``: the shapes, the weights' leaves and the
work counts of that model's layout), its plain reference (``reference``, a
path under ``perfbench/``) and its driver
(``perfbench/drivers/<driver>.py``).  So a new model comes in as new files.
The driver builds the program on the benchmark's weights, warms it, runs
the window, and checks what the window's entry produced against the plain
reference.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window runs under the profiler and the metrics are
the cell's per-layer metrics, each read by ``perfbench/metrics/<base>.py``,
``<base>`` being the metric's name before its first dot, so that one reader
serves a quantity split by the end-to-end metric it moves (a reader that
finds nothing to read returns None and the metric is left out).  The last key of the line, ``checks``, holds each compared number
beside its limit; the same lines end standard error.

The run exits non-zero without a result when no CUDA device (or fewer than
the cell asks for) is present, when the cell is unknown, or when the
process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Caches inside the checkout at fixed paths; the kernels' tile cache
    in the run's temporary directory, where no earlier run left winners;
    the program's sources on the path."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    tmp = os.environ.get("TMPDIR") or str(cache / "tmp")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(Path(tmp) / "repro_torch_autotune.json")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package this process holds, by top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """One cell, resolved from ``BENCHMARK.json`` and its files."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float,
                 trace: bool, root: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        from perfbench import check, generator, spec
        self.entry = cells[workload]
        self.name, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.config = spec.load_config_file(self.entry["config"], root)
        self.mix = generator.load_traffic_file(self.entry["traffic"], root)
        arch = self.config["arch"]
        self.arch = load_module(root / "arch" / f"{arch}.py", "perfbench_arch_" + arch)
        ref = Path(self.config["reference"])
        self.reference = load_module(root / ref, "perfbench_reference_" + ref.stem)
        self.spec = self.arch.spec_from_file(self.config)
        self.limits = check.load_limits(workload, root)
        self.chips = int(self.entry.get("chips", 1))
        self.bench, self.root = bench, root
        self.device, self.dtype, self.pcfg = "cuda", None, None
        self.t_setup, self.t_start = None, T_START

    def program_config(self) -> None:
        """The program's configuration, held against the file's shapes."""
        import torch

        from perfbench import spec
        from repro_torch.configs import get_config
        port = self.config["port"]
        self.pcfg = port_config(get_config(port["arch"]), port)
        self.dtype = getattr(torch, self.config["dtype"])
        bad = spec.mismatches(self.spec, self.arch.spec_from_port(self.pcfg))
        if bad:
            raise SystemExit(f"the program's {port['arch']!r} differs from "
                             f"configs/{self.entry['config']}.json on {bad}")

    def driver(self):
        """The driver module the configuration names."""
        name = self.config["driver"]
        return load_module(self.root / "drivers" / f"{name}.py", "perfbench_driver_" + name)

    def mark_setup(self) -> None:
        self.t_setup = time.perf_counter() - T_START


def port_config(pcfg, port: dict):
    """The program's configuration as the file's ``port`` block sets it:
    its depth, and the fields of ``moe`` (``MoEConfig``) and of ``attn``
    (every layer's ``AttentionSpec``) that the block names."""
    from dataclasses import replace
    attn = port.get("attn", {})

    def layer(s):
        return replace(s, attn=replace(s.attn, **attn))

    return replace(pcfg, num_layers=int(port["num_layers"]),
                   moe=pcfg.moe and replace(pcfg.moe, **port.get("moe", {})),
                   pattern=tuple(map(layer, pcfg.pattern)),
                   prefix=tuple(map(layer, pcfg.prefix)))


def metric_entries(bench: dict, cell: Cell, trace: bool) -> list:
    """The cell's metrics: end-to-end (trace 0) or per-layer (trace 1)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell.name in m["workloads"]]


def read_per_layer(bench: dict, cell: Cell, run) -> dict:
    out = {}
    for m in metric_entries(bench, cell, True):
        base = m["name"].split(".")[0]
        reader = load_module(cell.root / "metrics" / f"{base}.py", "perfbench_metric_" + base)
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class RunView:
    """What a per-layer metric reader sees: the cell, its spec and
    architecture file, the driver's record and the traced window."""

    def __init__(self, cell: Cell, record: dict, window):
        self.cell, self.spec, self.arch, self.mix = cell, cell.spec, cell.arch, cell.mix
        self.record, self.window = record, window


def device_info(cell: Cell, peak: int, window) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cell.trace:
        info["busy_s"] = window.busy_s()
        info["window_s"] = window.window_s
    return info


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    cell.program_config()
    from perfbench.trace import Window
    window = Window(cell.trace)
    out = cell.driver().run(cell, window)
    held = forbidden_modules()
    if held:
        print(f"no result: the process holds {held} after the window", file=sys.stderr)
        return 4
    return report(bench, cell, out, window)


def report(bench: dict, cell: Cell, out: dict, window) -> int:
    from perfbench import check
    record = out["record"]
    if cell.trace:
        metrics = read_per_layer(bench, cell, RunView(cell, record, window))
    else:
        metrics = {}
        for m in metric_entries(bench, cell, False):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": cell.t_setup, "unit": "s"}
            elif m["name"] in out["e2e"]:
                value, unit = out["e2e"][m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}
        lost = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
        if lost:
            print(f"no result: {lost} not finite ({out['failed']} of "
                  f"{out['attempted']} failed)", file=sys.stderr)
            return 5
    correct, checks = check.judge(out["readings"], cell.limits)
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics,
            "device": device_info(cell, record["memory_peak_bytes"], window)}
    if cell.trace:
        line["breakdown"] = {"device_ops": window.device_ops(),
                             "idle_gaps": window.idle_gaps()}
    line["checks"] = checks
    print(f"card: {power_limit()}; peaks used: 989 TFLOP/s bf16, 3.35 TB/s",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
