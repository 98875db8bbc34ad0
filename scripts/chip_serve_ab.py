#!/usr/bin/env python3
"""Hold two checkouts' serving steps against each other on one card.

    python3 scripts/chip_serve_ab.py PARENT_ROOT CHANGE_ROOT

Runs each checkout in a process of its own, in turns (parent, change,
change, parent): ``chip_smoke.py``'s build phase, then full-width
Mixtral-8x7B at 4 layers (``chip_smoke.SERVE_ARGS``, random weights from
its seed) through the CUDA-graph steps.  Each run prints the serve
trace's warm ms a pass on the slot map and on 16-token pages (five runs of
each after a first that captures the graphs) and on the slot map with every
step eager (five runs after a first), the device ms of one prefill
chunk and one extend chunk (1 x 16 tokens), and the device ms of a warm
4-slot decode wave, paged and on the slot map, at the serve trace's cache
length and at 4096, beside the card's name and power limit.  Needs a CUDA device; each
checkout must hold ``chip_smoke.py`` and ``src/repro_torch``.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r'''
TRACE_RUNS = 5
import sys, time
sys.path[:0] = [".", "src"]
import chip_smoke as c
import torch
from repro_torch.launch import serve
from repro_torch.serving import engine

c.build_phase()
sched, _ = serve.setup(serve.parse_args(c.SERVE_ARGS))
params, cfg, ctx, scfg = sched.params, sched.cfg, sched.ctx, sched.scfg
del sched
for name, flags in (("slot map", []), ("pages", ["--page-size", str(c.PAGE)]),
                    ("slot map, eager", ["--eager"])):
    ms = []
    for turn in range(1 + TRACE_RUNS):
        sched, trace = serve.setup(serve.parse_args(c.SERVE_ARGS + flags), params=params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = sched.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if turn:
            ms.append(1e3 * wall / (m["decode_waves"] + m["prefill_chunks"]))
        del sched
    passes = m["decode_waves"] + m["prefill_chunks"]
    print(f"AB trace on the {name}, ms a pass over {passes} passes, {TRACE_RUNS} warm runs: "
          f"median {sorted(ms)[len(ms) // 2]:.4f} ({', '.join(f'{x:.4f}' for x in ms)})",
          flush=True)
tok = torch.arange(16, device=ctx.device)[None]
prefill = engine.get_prefill_fn(cfg, ctx, scfg.cache_len)
dev, host, note = c.device_ms(lambda: prefill(params, {"tokens": tok}))
print(f"AB prefill chunk (1 x 16): device {dev:.4f} ms, host {host:.4f} ms{note}",
      flush=True)
extend = engine.get_extend_step(cfg, ctx)
holder = c._Holder()
own = extend.static_cache(engine.init_serve_cache(params, cfg, 1, scfg.cache_len), holder)


def extend_chunk():
    own["pos"].fill_(16)
    extend(params, own, tok)


dev, host, note = c.device_ms(extend_chunk)
print(f"AB extend chunk (1 x 16 at 16): device {dev:.4f} ms, host {host:.4f} ms{note}",
      flush=True)
for cache_len in (scfg.cache_len, c.PREFIX_CACHE_LEN):
    paged, slot, note = c._wave_ms(params, cfg, ctx, cache_len, 64)
    print(f"AB 4-slot decode wave at cache_len {cache_len}: paged {paged:.4f} ms, "
          f"slot map {slot:.4f} ms{note}", flush=True)
'''


def run(root: Path) -> list:
    """One checkout's lines."""
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        raise SystemExit(f"{root}: the run failed\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return [line[3:] for line in out.stdout.splitlines() if line.startswith("AB ")]


def main() -> int:
    parent, change = (Path(p).resolve() for p in sys.argv[1:3])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        for line in run(root):
            print(f"{label} {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
