#!/usr/bin/env python3
"""Split segment_outer's time on one card into a fixed cost per output
element and a cost per reduced row.

    python3 scripts/chip_wgrad_probe.py [--root CHECKOUT]

For Mixtral-8x7B's dw1 (E 8, K 4096, N 14336) and Llama-4-Scout's (E 16,
K 5120, N 8192), in write and add mode, times the bf16 kernel
(``chip_smoke.device_ms``: CUDA events around calls queued behind a spin
kernel, over rotating copies where the work is near the L2's size) at 64,
128, 256, 512 and 1024 live rows per expert, in 64-row blocks (bm 64, so
every count is whole blocks).  It fits time = fixed + rows x per-row by
least squares and prints both per output element (ps), the output's rate
at the fixed cost (TB/s: the bytes written, and read when adding, over the
fixed time), and each point beside its bound.  ``--root`` times another
checkout's kernel (its ``src``) with this checkout's timer, so that two
kernels can be compared in one call on one card.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROWS = (64, 128, 256, 512, 1024)
BM = 64
# (model, E, K, N): dw1 = bufᵀ @ dh1, the output of one expert weight
SHAPES = (("Mixtral-8x7B", 8, 4096, 14336), ("Llama-4-Scout", 16, 5120, 8192))


def fit(xs, ys):
    """Least-squares (intercept, slope) of ys over xs."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return my - slope * mx, slope


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose kernel is timed (default: this one)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import torch
    if not torch.cuda.is_available():
        print("chip_wgrad_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.weight_grad import segment_outer
    if not str(Path(build.__file__).resolve()).startswith(str(root)):
        raise SystemExit(f"imported {build.__file__}, not the kernel under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; kernel of {root}", flush=True)
    build.build(["weight_grad"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for model, E, K, N in SHAPES:
        elems = E * K * N
        for acc in (False, True):
            mode = "add" if acc else "write"
            out = torch.randn((E, K, N), generator=gen, device=dev).bfloat16()
            times = []
            for rows in ROWS:
                R = E * rows
                a = torch.randn((R, K), generator=gen, device=dev).bfloat16()
                b = torch.randn((R, N), generator=gen, device=dev).bfloat16()
                b2e = torch.arange(E, device=dev, dtype=torch.int32).repeat_interleave(
                    rows // BM)
                total = torch.tensor([R], device=dev, dtype=torch.int32)
                # read once, written once (and read once when adding)
                nbytes = 2 * (R * (K + N) + (2 if acc else 1) * elems)
                bms, by = cs._bound(nbytes, 2 * R * K * N)
                # in place, as the path calls it (adding: out grows, harmlessly)
                call = cs.rotated(lambda a_, b_: segment_outer(
                    a_, b_, b2e, total, BM, out, accumulate=acc), (a, b), nbytes)
                ms = cs.device_ms(call, 5, kernel_call=True)[0]
                times.append(ms)
                print(f"{model} {mode} E={E} K={K} N={N}, {rows} rows/expert: "
                      f"{ms:.4f} ms, bound {bms:.4f} ({by}), {100 * bms / ms:.1f}% of bound",
                      flush=True)
                del a, b, call
                torch.cuda.empty_cache()
            fixed, per_row = fit(ROWS, times)
            moved = (2 if acc else 1) * 2 * elems
            worst = max(abs(t - fixed - per_row * r) for r, t in zip(ROWS, times))
            print(f"fit {model} {mode}: fixed {fixed:.4f} ms = {1e9 * fixed / elems:.3f} ps "
                  f"per output element ({moved / (fixed * 1e-3) / 1e12:.2f} TB/s of output "
                  f"{'read and written' if acc else 'written'}); per row "
                  f"{per_row:.6f} ms = {1e9 * per_row / elems:.5f} ps per element per row "
                  f"({2 * E * K * N / (per_row * 1e-3) / 1e12:.1f} TFLOP/s); largest "
                  f"residual {worst:.4f} ms", flush=True)
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
