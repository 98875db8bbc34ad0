#!/usr/bin/env python3
"""Where a real CUDA OOM can be made for the trainer's degradation ladder.

    python3 scripts/chip_oom_shapes.py

On one full-width Mixtral-8x7B layer (bf16, EP at one peer, the fused leg;
random weights from seed 0), for each token shape of SHAPES: one forward +
backward at (1, 1), (2, 1) and (4, 1), and each one's max_memory_allocated
and max_memory_reserved.  Then, at the shape where (1, 1) allocates the
most above (2, 1), for each allocator configuration (the default, and
expandable segments) in a process of its own: one trainer step at (1, 1)
and at (2, 1) uncapped, then the (1, 1) step through the guard under a
``set_per_process_memory_fraction`` cap at the midpoint of the two steps'
reserved peaks, and at the midpoint of their allocated peaks: where each
capped step ended, and what failed.  ``chip_smoke.py``'s resilience phase
takes its shape and cap from this.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4096, 4), (2048, 8), (1024, 16), (512, 32), (256, 64))   # (seq, batch)
CONFS = ("", "expandable_segments:True")


def _cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mixtral-8x7b"), num_layers=1)


def _ctx(chunks: int):
    import torch
    from repro_torch.core.moe import DistContext
    return DistContext(device=torch.device("cuda"), moe_strategy="ep_shardmap",
                       moe_fused=True, moe_chunks=chunks, pipeline_chunks=1)


def shapes() -> tuple:
    """Forward + backward peaks by shape and chunk count; returns the shape
    with the widest allocated gap between (1, 1) and (2, 1)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.optim.adamw import param_list
    from repro_torch.training.step import init_train_state, loss_fn
    cfg = _cfg()
    state = init_train_state(cfg, torch.bfloat16, "cuda", seed=0)
    leaves = param_list(state.params)
    best = None
    for seq, b in SHAPES:
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in SyntheticLMData(cfg, seq, b, 0).batch_at(0).items()}
        peaks = {}
        for c in (1, 2, 4):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = loss_fn(state.params, cfg, _ctx(c), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
            peaks[c] = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
            del loss, grads
            print(f"{b} x {seq} ({c}, 1): forward + backward max_memory_allocated "
                  f"{peaks[c][0] / 1e9:.3f} GB, max_memory_reserved {peaks[c][1] / 1e9:.3f} GB",
                  flush=True)
        gap = peaks[1][0] - peaks[2][0]
        print(f"{b} x {seq}: (1, 1) above (2, 1) by {gap / 1e9:.3f} GB allocated", flush=True)
        if best is None or gap > best[0]:
            best = (gap, seq, b)
    return best[1], best[2]


def capped(seq: int, b: int) -> None:
    """In this process (its allocator configured by the parent): uncapped
    steps at (1, 1) and (2, 1), then (1, 1) under each cap rule."""
    import torch
    from repro_torch.training.trainer import Trainer
    cfg, total = _cfg(), torch.cuda.get_device_properties(0).total_memory

    def step(c: int, cap=None) -> dict:
        gc.collect()
        torch.cuda.empty_cache()
        if cap:
            torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            tr = Trainer(cfg, _ctx(c), seq_len=seq, global_batch=b, lr=1e-4,
                         dtype=torch.bfloat16, use_mact=False)
            t0 = time.perf_counter()
            tr.fit(1)
            torch.cuda.synchronize()
            return {"ended on": [tr.log[0]["chunks"], tr.log[0]["pipeline"]],
                    "failed": [e["error"][:60] for e in tr.guard.escalations],
                    "seconds": round(time.perf_counter() - t0, 3),
                    "allocated": torch.cuda.max_memory_allocated(),
                    "reserved": torch.cuda.max_memory_reserved()}
        except RuntimeError as e:
            return {"ended on": None, "error": str(e)[:200]}
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)

    runs = {c: step(c) for c in (1, 2)}
    for c, r in runs.items():
        print(f"  uncapped ({c}, 1): {json.dumps(r)}", flush=True)
    for rule, key in (("reserved", "reserved"), ("allocated", "allocated")):
        cap = (runs[1][key] + runs[2][key]) / 2
        print(f"  cap at the midpoint of the {rule} peaks, {cap / 1e9:.3f} GB: "
              f"{json.dumps(step(1, cap))}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_oom_shapes: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if len(sys.argv) == 4 and sys.argv[1] == "--capped":
        capped(int(sys.argv[2]), int(sys.argv[3]))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    seq, b = shapes()
    gc.collect()
    torch.cuda.empty_cache()
    for conf in CONFS:
        print(f"{b} x {seq}, PYTORCH_CUDA_ALLOC_CONF={conf!r}:", flush=True)
        subprocess.run([sys.executable, __file__, "--capped", str(seq), str(b)],
                       env={**os.environ, "PYTORCH_CUDA_ALLOC_CONF": conf},
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
