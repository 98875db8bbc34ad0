#!/usr/bin/env python3
"""Hold two checkouts' 4-slot decode wave against each other on one card,
kernel by kernel.

    python3 scripts/chip_wave_probe.py PARENT_ROOT CHANGE_ROOT

Runs each checkout in a process of its own, in turns (parent, change,
change, parent): ``chip_smoke.py``'s build phase, then full-width
Mixtral-8x7B at 4 layers (``chip_smoke.SERVE_ARGS``, random weights from
its seed).  Each run prints the device ms of a warm 4-slot decode wave
(``chip_smoke._wave_ms``: paged and on the slot map, at cache_len 88, 4096
and 88 again), of the slot-map graph on a fresh cache at 64 tokens with
token 1 in every slot and with random tokens, and the per-kernel device
time of five eager waves under ``torch.profiler``.  Needs a CUDA device;
each checkout must hold ``chip_smoke.py`` and ``src/repro_torch``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r'''
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
for cache_len in (88, 4096, 88):
    paged, slot, note = c._wave_ms(params, cfg, ctx, cache_len, 64)
    print(f"P wave_ms {cache_len}: paged {paged:.4f} slot {slot:.4f}{note}", flush=True)
step = engine.get_decode_step(cfg, ctx)
for kind in ("ones", "random"):
    for cache_len in (88, 4096):
        holder = c._Holder()
        own = step.static_cache(engine.init_serve_cache(params, cfg, 4, cache_len), holder)
        own["pos"].fill_(64)
        tok = (torch.ones((4, 1), dtype=torch.long, device="cuda") if kind == "ones"
               else torch.randint(0, cfg.vocab_size, (4, 1), generator=torch.Generator().manual_seed(0)).cuda())
        ms, host, note = c.device_ms(lambda: step(params, own, tok))
        own["pos"].fill_(64)
        print(f"P fresh slot wave {kind} {cache_len}: {ms:.4f}{note}", flush=True)
        if kind == "ones" and cache_len == 88:
            from torch.profiler import ProfilerActivity, profile
            cache = engine.init_serve_cache(params, cfg, 4, cache_len)
            cache["pos"].fill_(64)
            for _ in range(3):
                step.eager(params, cache, tok); cache["pos"].fill_(64)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    step.eager(params, cache, tok); cache["pos"].fill_(64)
                torch.cuda.synchronize()
            rows = sorted(((e.self_device_time_total / 5e3, e.count // 5, e.key) for e in prof.key_averages()
                           if e.self_device_time_total > 0), reverse=True)
            print(f"P eager kernels total {sum(r[0] for r in rows):.4f} ms", flush=True)
            for r in rows[:25]:
                print(f"P   {r[0]:.4f} ms x{r[1]} {r[2][:110]}", flush=True)
        del own, holder
'''



def run(root: Path) -> list:
    """One checkout's lines."""
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        raise SystemExit(f"{root}: the run failed\n{out.stdout[-3000:]}{out.stderr[-3000:]}")
    return [line[2:] for line in out.stdout.splitlines() if line.startswith("P ")]


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
