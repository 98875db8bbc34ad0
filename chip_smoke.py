#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  -- the card's name and power limit (nvidia-smi).
2. build   -- nvcc builds every kernel of the port from
              src/repro_torch/kernels/csrc (sm_90a), one nvcc per source,
              all started together; ptxas's registers and spills of the
              Hopper (TMA + wgmma) kernels are printed, and a spill fails.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the shapes its path gives it (serving: the grouped kernels;
              training: dispatch, ragged matmul at its three layouts and
              SwiGLU, fused MoE, the expert weights' gradient written and
              added into a buffer, each also at an EP rank's layout: R
              4608 rows from 2 source blocks with -1 gaps, 4 local
              experts, and at a placed EP rank's: R 4736, 5 weight slots
              (a replica slot per rank); attention: flash attention at
              Mixtral-8x7B's heads), in fp32 and bf16, and the grouped
              kernels also at Jamba-1.5-Large's MoE shapes (16 experts,
              d_model 8192, d_ff 24576) in bf16, each timed beside the
              plain version, a one-call PyTorch yardstick where there is
              one, and the card's bound.  Times are device times (CUDA
              events around calls queued while a spin kernel holds the card:
              device_ms; the training path's kernels of a size near the
              L2 cache's, the dispatch kernels, over rotating copies of
              their inputs, so from a cold L2 as on the path), with the
              host's wall clock per call of back-to-back calls beside
              them.  The Hopper kernels and scatter_rows are relaunched
              and must repeat their first output bit for bit; the
              dispatch kernels must equal their plain versions bit for
              bit.  Then the three kernels with a runtime row tile (bf16
              ragged_matmul in both layouts, fused_moe's down pass,
              segment_outer) at the training chunk's layout, each at tm 64
              and 128: bit-equal, each tile's device ms beside the bound,
              and autotune() searching the two into a cache of its own
              (default, winner and each candidate's ms printed).
4. serve   -- repro_torch.launch.serve drives full-width Mixtral-8x7B (depth
              cut to 4 layers, random bf16 weights from a seed) through an
              8-request trace, every decode wave and prefill chunk a replay
              of a captured CUDA graph (serving/engine.py); every request
              must finish with finite logits, and each grouped kernel must
              have launched once per MoE layer per pass, replays counted.
              Then the scheduler's reset() and the same trace again: the
              same streams, order and counts, and no graph captured.
5. profile -- the same trace on the same weights, eager and compiled in
              turns, three runs each, the compiled ones on warm graphs:
              streams, admission order and counts must equal the serve
              phase's.  Then one run each way under torch.profiler (device
              busy time, by kernel), each run's ms a pass, tok/s, p50/p99,
              device idle share, peak memory against the modeled peak, and
              one decode wave both ways: logits bit for bit, device time.
6. serve (paged) -- the serve phase's weights served from 16-token pages
              (serving/paged_scheduler.py): (a) the serve trace against a
              slot-map run, every sampled logits row bit-equal and every
              warm wave a replay of one paged decode graph; (b) 8 requests
              sharing a 32-token system prompt at cache_len 4096 (the
              whole window) with the prefix trie (at least 4 hits) and
              without (same streams); (c) the same under a budget of about
              two requests' worst case with preemption (at least one, same
              streams), then with an OOM injected at the first spill (the
              allocator audits clean).  Each prints tok/s, p50/p99, page
              high-watermark against the slot map's modeled cache bytes,
              max_memory_allocated, spill and restore ms, and the warm
              4-slot wave's device ms paged against the slot map's.
7. serve (expert-aware) -- the serve trace in five slot-map modes and two
              paged ones (waves of 2, expert batching, 2 resident experts,
              the router probe): streams equal the serve phase's, sampled
              logits rows bit-equal to the default run's, no graph captured
              across restores, admission at a budget between two
              all-resident peaks, a restore's time and the weights handed
              back bit for bit.
8. serve (hybrid) -- full-width Jamba-1.5-Large (the first 4 layers of its
              period: mamba/dense, mamba/MoE, mamba/dense, attention/MoE;
              45.96 GB of bf16 weights) through the launcher, then eager and
              compiled in turns (streams equal; ms a pass, tok/s, p50/p99,
              device idle share, peak against the modeled bytes); the same
              weights from 16-token pages (the serve trace's logits rows
              bit-equal to the slot map's, the shared-stem trace with the
              trie, a tight budget with preemption; state blocks' bytes
              beside the K/V pages'); waves of 2, every non-member's mamba
              state read on the host before and after its wave; then
              Mamba2-130m whole, eager and compiled in turns.
9. serve (enc-dec + VLM) -- full-width Whisper-small whole (12 encoder and
              12 decoder layers; 4 requests of 1500 seeded frames and 16-64
              prompt tokens, each prefilled alone, decoded as 4 rows) and
              InternVL2-76B's backbone cut to 8 of its 80 layers (17.9 GB
              bf16; 4 requests of 256 seeded patch embeddings ahead of 32
              prompt tokens, one batched prefill): 32 greedy decode steps
              eagerly and through the decode graph in turns, streams equal
              and every step's logits bit-equal; ms a pass, tok/s, device
              idle share (a profiled run's device ms against a warm run),
              peak against the weights + decode_cache_bytes.  Whisper's
              requests also from 16-token pages, the cross K/V in each
              request's state block: every logits row bit-equal to the slot
              map's; the state block's bytes beside a K/V page's.
10. train  -- repro_torch.launch.train trains full-width Mixtral-8x7B (depth
              cut to 2 layers, bf16 weights, fp32 AdamW moments) for 4 steps
              of 2 x 2048 tokens on the EP strategy at one peer with the
              fused expert leg, MACT choosing the schedule; every loss and
              grad norm must be finite and every kernel of the path must
              have launched.  Then one more step under torch.profiler, and
              the peak of one forward + backward against MACT's modeled
              activation bytes at MACT's schedule, at (2, 1) and unchunked:
              two sequential chunks must not raise it above one chunk's.
              Then one forward + backward at MACT's schedule from one state
              and batch, with the default row tiles and under a cache that
              forces the other tile on every tunable kernel: the loss and
              every gradient bit-equal.
11. train (ragged leg) -- the same model and steps through Trainer, built as
              launch/train.py builds it, on the three-launch ragged leg
              (dispatch buffer, ragged_swiglu, ragged_matmul, combine);
              fused_moe must not launch.  The same profile and peaks (Eq. 2
              with the dispatch buffer's term).
12. train (EP, 2 ranks) -- launch/train.py --mesh 1x2 as 2 ranks on the one
              card over gloo (started as torchrun starts them): the same
              model, batch and steps, each rank holding 4 of the 8 experts
              of each layer and one of the two sequences, on the fused leg,
              then the ragged leg through Trainer.  Each rank reports its
              log, schedules, peak against MACT's per-rank model, forward +
              backward peaks, exchanges and their time on gloo, and kernel
              launches; the phase fails on a non-finite loss, ranks that
              disagree, a kernel of a leg that did not launch on a rank,
              (2, 1) above (1, 1), or a step-1 ce off the one-peer run's.
13. train (adaptive + placement, 2 ranks) -- the EP phase's model, mesh,
              batch and fused leg, 3 steps, layer 0's router zeroed after
              init (step 1 sends every token to experts 0 and 1, which
              identity places on rank 0): launch/train.py with global
              MACT, with --adaptive-mact, and with --adaptive-mact
              --placement --placement-replicas 1, then the placed run on the
              ragged leg through Trainer.  Each run prints, per step and
              layer, the imbalance and each rank's received token-slots,
              its schedule vectors, replans (migrated slots, the weight
              exchange's bytes a step), the weight exchange's calls, bytes
              and host ms a step, warm step seconds, and each rank's peak
              against MACT's per-rank model with the replica term; the
              placed runs also the forward + backward peak with the
              placement above the same schedule at identity.  The phase
              fails on a non-finite loss, ranks that disagree, a kernel of
              the leg that did not launch at the 5-slot layout, layer 0
              still at identity after the first replan, layer 1 moved,
              layer 0's step-1 imbalance under 1.5, layer 0's hottest rank
              receiving no fewer token-slots after the replan, (2, 1)
              above (1, 1) on a placed run, or a placed run's first step
              (identity at cold start) that differs from the global run's
              in one bit.
14. train (resilience) -- full-width Mixtral-8x7B at 1 layer, bf16, fused
              leg: (a) launch/train.py --inject "oom@2,burst@2x64"
              --no-pipeline for 4 steps of 2 x 2048 tokens must escalate
              once, at step 2, to a deeper chunk count, and the burst must
              raise MACT's next chunk count; (b) in a process whose
              allocator maps expandable segments, one step of 32 x 512
              tokens at (1, 1), (2, 1) and (4, 1), then (1, 1) under a
              memory cap between the peaks of (1, 1) and (2, 1): a real
              torch.cuda.OutOfMemoryError must be caught by the guard and
              the step must end on a rung bit-equal (loss and a digest of
              every parameter and moment) to the uncapped run on it; (c)
              run A 4 steps, run B checkpointing every 2 steps and crashing
              at step 3, run C resuming to step 4: C's losses and final
              digest equal A's (checkpoint bytes, save, verify and restore
              seconds printed; the disk must hold the payload); (d) the
              same kill-and-resume on 2 card ranks (gloo, reduced config),
              an injected OOM walked in lockstep, and one rank's torn
              payload invalidating the step for both.
15. train (families) -- 3 steps each, bf16, through Trainer as
              launch/train.py builds it: Whisper-small whole (4 x 448
              decoder tokens, 1500 frames each), InternVL2-76B at 2 layers
              (2 x 2048 positions, 256 of them patches), Mamba2-130m whole
              (2 x 2048), Jamba-1.5-Large at 1 layer (mamba/dense: the SSD
              backward at d_model 8192) and Llama-4-Scout at 1 layer (16
              experts top-1 and a shared expert, 2 x 1024, the EP fused leg
              at one peer with MACT): finite losses and grad norms,
              parameters changed, warm step seconds, tokens/s, peak against
              the memory model (MACT's for the MoE run); every fused-leg
              kernel must launch on Llama-4-Scout.
16. kernels (Llama-4-Scout) -- the fused leg's kernels (scatter_rows,
              gather_combine, ragged_matmul, fused_moe, segment_outer) at
              Llama-4-Scout's MoE shapes (16 experts top-1, d_model 5120,
              d_ff 8192) and the chunk MACT chose in the train (families)
              run, at one peer: each against its plain version in fp32 and
              bf16, relaunched, timed beside the plain version, the library
              yardstick and the bound, and the row tiles checked, timed and
              searched, as in phase 3.
17. check  -- the reduced Mixtral config in fp32 on the card (TF32 off for
              matmuls and cuDNN) against the same weights on the CPU: prefill
              logits and greedy token streams must agree, and 2 training
              steps on each leg must give the same schedules and losses, at
              one peer and on a 2x2 mesh (4 gloo ranks on the card against
              4 on the CPU), where 2 fused-leg steps with adaptive MACT and
              expert placement (a replica slot per rank, layer 0's router
              zeroed) must also give the same schedule vectors and
              placements.  The reduced Jamba and Mamba2 in fp32 on the card
              against the CPU (prefill logits, greedy streams), and the
              reduced Jamba with 2 of 4 experts resident and the prefetch
              off, so decode waves re-run: the default run's streams.
              The reduced Whisper-small and InternVL2-76B in fp32 on the
              card against the CPU (prefill logits, greedy streams), and one
              training step of every reduced config of the registry (the
              fused leg where it has MoE layers): losses and grad norms
              within 1e-4.  Two ragged-leg steps under selective remat: the
              card against the CPU within 1e-5, the q, k, v projections
              computed once a step on both; and the bytes a forward holds
              for the backward under "none" > "selective" > "full".

The run reads and writes its own empty tile cache (REPRO_TORCH_AUTOTUNE_CACHE
in a temporary directory), so a cache under $HOME changes no phase, and the
tile search's winners go to a file of their own: every phase but the tile
checks runs the default tiles.

The next-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: 3.35 TB/s HBM3, 989 TFLOP/s dense bf16, 67 TFLOP/s
# fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# (E, M, K, N) of each kernel at decode (4 slots folded into M) and at a
# prefill chunk (the trace's 16 tokens; 32 as a second chunk size)
DECODE_M, PREFILL_MS = 4, (16, 32)
E, D_MODEL, D_FF = 8, 4096, 14336
TOL_F32 = 1e-4      # fp32 sums in another order, K up to 14336
# Jamba-1.5-Large's MoE layers: the widest the repo's configs have
JAMBA_E, JAMBA_D_MODEL, JAMBA_D_FF = 16, 8192, 24576
TOL_BF16 = 1e-2     # one bf16 ulp is at most 2**-7 relative

TRAIN_ARGS = ["--arch", "mixtral-8x7b", "--layers", "2", "--ep", "--fused",
              "--steps", "4", "--seq-len", "2048", "--global-batch", "2",
              "--lr", "1e-4", "--seed", "0"]
# the training path's kernel shapes: a 2048-token FCDA chunk (MACT picks 2
# chunks of the 2 x 2048 tokens), top-2 of 8 experts, EP at one peer:
# cap_send = 2 x 2048 = 4096 sent rows, R = 4096 + 8 x 128 = 5120 ragged rows
T_CHUNK, TOP_K, BLOCK_M = 2048, 2, 128
PLAIN_TRAIN_GB = 41.0     # the reckoned peak: 38 GB of train state + activations
RAGGED_STEPS = 4

# attention at Mixtral-8x7B's heads (32 query heads, KV repeated, head dim
# 128, sliding window 4096): a 2 x 2048-token step's prefill, where the
# window does not cut, and one 8192-token sequence, where it does
# (BH, S, causal, window)
ATTN_SHAPES = ((64, 2048, True, 4096), (32, 8192, True, 4096))
HEAD_DIM = 128
TOL_ATTN_F32 = 2e-5     # the JAX package's tolerance for its own kernel

SERVE_ARGS = ["--arch", "mixtral-8x7b", "--layers", "4", "--requests", "8",
              "--max-slots", "4", "--prompt-lens", "16,32,48,64",
              "--prefill-chunk", "16", "--gen", "8,24", "--arrival-rate", "0",
              "--seed", "0"]


T_START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's header, with the seconds since the script started: the
    script must end within its time limit, so each run shows where it
    went."""
    print(f"== {name} (at {time.perf_counter() - T_START:.0f} s)", flush=True)


def device_phase() -> str:
    phase("device")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


# the Hopper (TMA + wgmma) kernels, whose register and spill report the build
# phase prints by name: their accumulators must stay in registers (the
# shared mainloop's instantiations name their epilogue: RaggedStore for
# ragged_matmul, SwigluStore for ragged_swiglu, FusedUpStore and
# FusedCombine for fused_moe's passes)
HOPPER_KERNELS = ("ragged_wgmma", "grouped_wgmma", "flash_wgmma_kernel",
                  "weight_grad_wgmma")
NO_SPILLS = "0 bytes spill stores, 0 bytes spill loads"


def ptxas_report(log: str) -> list:
    """(entry function, its registers line, its spill line) from nvcc's
    -Xptxas -v output."""
    out, fn, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn, spill = ln.split("'")[1], ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and fn:
            out.append((fn, ln.split(":", 1)[1].strip(), spill))
            fn = None
    return out


def build_phase() -> None:
    phase("build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    for name, info in build.build().items():
        print(f"built {name} in {info['seconds']:.1f} s"
              + (" (cached)" if info["cached"] else ""), flush=True)
        for ln in info["log"].splitlines():
            if "warning" in ln.lower():
                print(f"  {ln.strip()}", flush=True)
        for fn, regs, spill in ptxas_report(info["log"]):
            hopper = next((k for k in HOPPER_KERNELS if k in fn), None)
            if hopper:
                args = fn[fn.index(hopper) + len(hopper):][:90]
                print(f"  ptxas {hopper}{args}: {regs}; {spill}", flush=True)
                if NO_SPILLS not in spill:
                    raise SystemExit(f"{hopper}{args} spills: {spill}")
    print(f"build phase {time.perf_counter() - t0:.1f} s", flush=True)


SPIN_CYCLES_PER_MS = 2.0e6     # the H100's SM clock is at most 1.98 GHz
MAX_SPIN_MS = 100.0            # a call that synchronizes is never queued, however long


def device_ms(fn, iters: int = 10, kernel_call: bool = False) -> tuple[float, float, str]:
    """(device ms, host ms, note) of one call after two warm-up calls.

    Host: the wall clock of ``iters`` back-to-back calls ending in a
    synchronize, over ``iters``.  Device: CUDA events around ``iters`` calls
    that the host queued while a spin kernel held the card, so the card runs
    them back to back and the events read its time, not the host's (events
    around calls the card runs as they come read the host's time when a
    small kernel's wrapper costs more than the kernel).  The card must not
    have reached the first call when the last was queued (retried once with
    a longer spin).  A call that synchronizes the host can never be queued:
    a kernel's wrapper must not (``kernel_call``: fail), and for a plain version
    or library call the note says that its time includes the host's."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin_ms = 2 * enqueue_ms + 1.0
    for _ in range(2):
        torch.cuda._sleep(int(min(spin_ms, MAX_SPIN_MS) * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            break
        spin_ms *= 4
    if kernel_call and not queued:
        raise SystemExit("a kernel wrapper synchronized the host: its device time "
                         "cannot be read apart from the host's")
    note = "" if queued else " (synchronizes: includes host time)"
    return start.elapsed_time(stop) / iters, host_ms, note


L2_BYTES = 50e6       # the H100's L2 cache


def rotated(fn, args, nbytes: float):
    """``fn(*args)`` as a call that ``device_ms`` times from a cold L2 cache
    when the work moves little more than the cache holds (``nbytes``): each
    call takes the next of n copies of the tensor inputs, and each output
    is kept until n calls later, so that between two uses of one buffer the
    calls move 4x the cache's bytes.  Back to back on one set of buffers,
    such work is partly served from the L2 and reads above its HBM bound;
    on the path the other kernels between two calls evict it."""
    import collections
    import itertools
    import math

    import torch
    n = math.ceil(4 * L2_BYTES / nbytes)
    if n <= 1:
        return lambda: fn(*args)
    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                     for _ in range(n - 1)]
    outs = collections.deque(maxlen=n)
    turn = itertools.cycle(sets)
    return lambda: outs.append(fn(*next(turn)))


def bound_ms(E_, M, K, N, n_weights: int, elem_bytes: int = 2):
    """The least time for the work: each input read once, the output written
    once, at the memory rate; or the products at the bf16 tensor rate."""
    nbytes = elem_bytes * (E_ * M * K + n_weights * E_ * K * N + E_ * M * N)
    flops = 2 * n_weights * E_ * M * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# the keys of a kernel's line taken from its first (main-path) shape
ROW_KEYS = ("max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def _fmt(ms) -> str:
    return "-" if ms is None else f"{ms:.4f}"


def _max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _close(a, b, tol: float) -> bool:
    import torch
    return torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)


REPEATS = 8     # relaunches of a Hopper kernel held to its first output


def repeat_check(name: str, label: str, fn, first) -> None:
    """A pipeline fault (a stage overwritten before its products are done)
    shows as rare mismatches: every relaunch must equal the first output
    bit for bit."""
    import torch
    for i in range(REPEATS):
        if not torch.equal(fn(), first):
            raise SystemExit(f"{name} at {label}: relaunch {i + 1} differs from the first")
    print(f"{name} {label}: {REPEATS} relaunches equal the first bit for bit", flush=True)


def kernels_phase() -> dict:
    """Check and time both kernels; returns {kernel name: entry}."""
    phase("kernels")
    import torch
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    # weights at the model's init scale, made once in fp32, cast for bf16
    w1 = randn((E, D_MODEL, D_FF), D_MODEL ** -0.5)
    w3 = randn((E, D_MODEL, D_FF), D_MODEL ** -0.5)
    w2 = randn((E, D_FF, D_MODEL), D_FF ** -0.5)
    wb = {k: v.bfloat16() for k, v in (("w1", w1), ("w3", w3), ("w2", w2))}

    specs = {
        "grouped_swiglu": dict(fn=gm.grouped_swiglu, plain=ref.grouped_swiglu_ref,
                               weights=("w1", "w3"), K=D_MODEL, N=D_FF,
                               library=None, replaces="src/repro/kernels/grouped_mlp.py:106"),
        "grouped_matmul": dict(fn=gm.grouped_matmul, plain=ref.grouped_matmul_ref,
                               weights=("w2",), K=D_FF, N=D_MODEL,
                               library=torch.bmm, replaces="src/repro/kernels/grouped_mlp.py:81"),
    }
    w32 = {"w1": w1, "w3": w3, "w2": w2}
    entries = {}
    for name, s in specs.items():
        shapes = []
        for M in (DECODE_M, *PREFILL_MS):
            x32 = randn((E, M, s["K"]))
            ws32 = [w32[k] for k in s["weights"]]
            wsb = [wb[k] for k in s["weights"]]
            xb = x32.bfloat16()
            got32, want32 = s["fn"](x32, *ws32), s["plain"](x32, *ws32)
            gotb, wantb = s["fn"](xb, *wsb), s["plain"](xb, *wsb)
            torch.cuda.synchronize()
            err32, errb = _max_err(got32, want32), _max_err(gotb, wantb)
            ok = _close(got32, want32, TOL_F32) and _close(gotb, wantb, TOL_BF16)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version at M={M} "
                                 f"(bf16 tol {TOL_BF16}, f32 tol {TOL_F32}): "
                                 f"err bf16 {errb:.3e} f32 {err32:.3e}")
            repeat_check(name, f"E={E} M={M} K={s['K']} N={s['N']}",
                         lambda: s["fn"](xb, *wsb), gotb)
            ms, host_ms, _ = device_ms(lambda: s["fn"](xb, *wsb), kernel_call=True)
            plain_ms, plain_host, plain_note = device_ms(lambda: s["plain"](xb, *wsb))
            lib_ms, lib_host, lib_note = (device_ms(lambda: s["library"](xb, *wsb))
                                          if s["library"] is not None else (None, None, ""))
            bms, by = bound_ms(E, M, s["K"], s["N"], len(wsb))
            row = {"M": M, "K": s["K"], "N": s["N"], "max_abs_err": errb,
                   "max_abs_err_f32": err32, "ms": ms, "host_ms": host_ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": lib_ms}
            shapes.append(row)
            print(f"{name} E={E} M={M} K={s['K']} N={s['N']}: ok err bf16 {errb:.3e} "
                  f"f32 {err32:.3e} | device ms: kernel {ms:.4f}, plain {plain_ms:.4f}"
                  f"{plain_note}, library {_fmt(lib_ms)}{lib_note} | host ms per call: "
                  f"kernel {host_ms:.4f}, "
                  f"plain {plain_host:.4f}, library {_fmt(lib_host)} | bound "
                  f"{bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of bound", flush=True)
        head = shapes[0]           # the decode wave: most of the path's launches
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_mlp.cu",
            "replaces": s["replaces"], "launches": 0,
            **{k: head[k] for k in ROW_KEYS},
            "shapes": shapes,
        }
    del w1, w3, w2, wb, w32
    torch.cuda.empty_cache()
    jamba_kernels(entries, randn)
    return entries


def jamba_kernels(entries: dict, randn) -> None:
    """Both grouped kernels at Jamba-1.5-Large's MoE shapes (16 experts,
    d_model 8192, d_ff 24576) in bf16, the serve (hybrid) path's type:
    against the plain version, relaunched, timed beside the plain version,
    torch.bmm for grouped_matmul and the bound.  The fp32 forms run at the
    reduced size in the check phase; at this width their weights alone
    would take 38.7 GB."""
    import torch
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.kernels import ref

    E_, K_, N_ = JAMBA_E, JAMBA_D_MODEL, JAMBA_D_FF
    w = {"w1": randn((E_, K_, N_), K_ ** -0.5).bfloat16(),
         "w3": randn((E_, K_, N_), K_ ** -0.5).bfloat16(),
         "w2": randn((E_, N_, K_), N_ ** -0.5).bfloat16()}
    torch.cuda.empty_cache()                      # the fp32 draws
    specs = {"grouped_swiglu": (gm.grouped_swiglu, ref.grouped_swiglu_ref,
                                ("w1", "w3"), K_, N_, None),
             "grouped_matmul": (gm.grouped_matmul, ref.grouped_matmul_ref,
                                ("w2",), N_, K_, torch.bmm)}
    for name, (fn, plain, names, K, N, library) in specs.items():
        ws = [w[k] for k in names]
        for M in (DECODE_M, PREFILL_MS[0]):
            xb = randn((E_, M, K)).bfloat16()
            got, want = fn(xb, *ws), plain(xb, *ws)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            label = f"E={E_} M={M} K={K} N={N}"
            if not _close(got, want, TOL_BF16):
                raise SystemExit(f"{name} disagrees with its plain version at Jamba's "
                                 f"{label} (bf16 tol {TOL_BF16}): err {err:.3e}")
            del want
            repeat_check(name, f"Jamba {label}", lambda: fn(xb, *ws), got)
            ms, host_ms, _ = device_ms(lambda: fn(xb, *ws), kernel_call=True)
            plain_ms, _, plain_note = device_ms(lambda: plain(xb, *ws), iters=2)
            torch.cuda.empty_cache()
            lib_ms, _, lib_note = (device_ms(lambda: library(xb, *ws))
                                   if library is not None else (None, None, ""))
            bms, by = bound_ms(E_, M, K, N, len(ws))
            entries[name]["shapes"].append({
                "model": "jamba-1.5-large-398b", "M": M, "K": K, "N": N,
                "max_abs_err": err, "ms": ms, "host_ms": host_ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": lib_ms})
            print(f"{name} Jamba {label} bf16: ok err {err:.3e} | device ms: kernel "
                  f"{ms:.4f}, plain {plain_ms:.4f}{plain_note}, library "
                  f"{_fmt(lib_ms)}{lib_note} | host ms per call {host_ms:.4f} | bound "
                  f"{bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of bound", flush=True)
    del w, ws
    torch.cuda.empty_cache()


def _routed_chunk(gen, dev, t: int, n_exp: int, k: int):
    """One FCDA chunk's routing at one peer, and the plans the EP leg
    derives from it: ids of the top-``k`` distinct experts of ``n_exp``
    for each of ``t`` tokens."""
    import torch
    from repro_torch.core import dispatch as dsp
    scores = torch.rand((t, n_exp), generator=gen, device=dev)
    ids = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    up = dsp.make_unified_plan(ids.to(torch.int32), n_exp, 1, cap_send=t * k)
    rows = t * k
    R = -(-(rows + n_exp * BLOCK_M) // BLOCK_M) * BLOCK_M
    plan = dsp.recv_ragged_plan(up.counts, dsp.eids_from_counts(up.counts, rows),
                                R, BLOCK_M)
    return up, plan, R


def _ep_rank_layout(gen, dev, spec=None):
    """The received layout of rank 0 of the EP phase's 1 x 2 mesh at MACT's
    (2, 2): each of P = 2 ranks routes a t_c = 1024-token chunk over 8
    experts and sends rank 0 a cap_send = 2048-row block (its rows for
    rank 0's groups, -1 past them); rank 0's E_local groups get the ragged
    plan over R = P cap_send + E_local bm rows.  The groups are experts
    0-3, or, under a placement ``spec``, rank 0's slots_per_peer weight
    slots (routed ids mapped to slots as core/ep.py maps them).  Returns
    (plan, rows received, R, E_local, rank 0's own send slots (t_c, k) into
    its P cap_send send and return rows, the experts of rank 0's groups)."""
    import torch
    from repro_torch.core import dispatch as dsp
    from repro_torch.core.placement import place_expert_idx
    P, t_c = EP_MESH[1], T_CHUNK // 2
    groups = spec.total_slots if spec is not None else E
    e_local = groups // P
    cap = t_c * min(TOP_K, e_local)
    plans = []
    for _ in range(P):
        scores = torch.rand((t_c, E), generator=gen, device=dev)
        ids = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :TOP_K]
        sel = place_expert_idx(ids.to(torch.int32), spec)
        plans.append(dsp.make_unified_plan(sel, groups, P, cap_send=cap))
    counts = [up.counts[0] for up in plans]
    recv_cnt = torch.stack(counts)                       # (P, E_local) for rank 0
    R = -(-(P * cap + e_local * BLOCK_M) // BLOCK_M) * BLOCK_M
    plan = dsp.recv_ragged_plan(recv_cnt, dsp.eids_from_counts(recv_cnt, cap), R, BLOCK_M)
    experts = (list(spec.slot_to_expert[:e_local]) if spec is not None
               else list(range(e_local)))
    return plan, P * cap, R, e_local, plans[0].send_slots, experts


# the kernels' layout under expert placement (phase "train (adaptive +
# placement, 2 ranks)"): one replica slot per rank, so rank 0 of the 1 x 2
# mesh runs 5 weight slots, planned for a layer whose load is skewed toward
# experts 0 and 1 (the phase's layer 0)
PLACED_LOAD = (100, 100, 10, 10, 10, 10, 10, 10)


# the TPU kernel each training-path kernel replaces
REPLACES = {"scatter_rows": "src/repro/kernels/dispatch_pallas.py:63",
            "gather_combine": "src/repro/kernels/dispatch_pallas.py:127",
            "ragged_matmul": "src/repro/kernels/ragged_mlp.py:99",
            "ragged_swiglu": "src/repro/kernels/ragged_mlp.py:131",
            "fused_moe": "src/repro/kernels/fused_moe.py:105"}


def _bound(nbytes: float, flops: float, rate: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _chunk_cases(gen, dev, randn, t: int, n_exp: int, k: int, d: int, f: int,
                 tag: str = ""):
    """The one-peer EP leg's kernel cases for one FCDA chunk of ``t``
    tokens routed top-``k`` over ``n_exp`` experts of width ``d`` x ``f``
    (``_routed_chunk``'s layout), ``tag`` before each label.  Returns
    (cases: name -> list of (label, kernel fn, plain fn, fp32 inputs,
    library fn or None, bytes, flops, fp32 tolerance: 0 for bit-equality in
    both dtypes), the layout's tensors)."""
    import types

    import torch
    import torch.nn.functional as F
    from repro_torch.core.dispatch import invert_slots
    from repro_torch.kernels import dispatch_cuda as dc
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_moe import fused_moe
    from repro_torch.kernels.ragged_mlp import ragged_matmul, ragged_swiglu

    up, plan, R = _routed_chunk(gen, dev, t, n_exp, k)
    rows = t * k
    live = int(plan.total_rows)                   # rows this run's data fills
    used = torch.unique(plan.block_to_expert[:live // BLOCK_M]).numel()
    send_pos = invert_slots(up.send_slots, rows)
    send_src = torch.where(send_pos >= 0, send_pos // k, -1).to(torch.int32)
    recv_pos = invert_slots(plan.slots, R)
    recv_src = torch.where(recv_pos >= 0, recv_pos, -1).to(torch.int32)
    weights = torch.rand((t, k), generator=gen, device=dev)
    if k > 1:
        # top-k softmax weights sum to 1; a top-1 router's weight is its
        # gate (Llama-4's sigmoid), left as drawn
        weights = weights / weights.sum(-1, keepdim=True)
    # the combine backward's scatter: each ragged row a slot weight, rows
    # past the routed load and padding rows of a block dead
    wrow = torch.rand(R, generator=gen, device=dev)
    recv_read = int(((recv_src >= 0) & (torch.arange(R, device=dev) < live)).sum())

    w1 = randn((n_exp, d, f), d ** -0.5)
    w3 = randn((n_exp, d, f), d ** -0.5)
    w2 = randn((n_exp, f, d), f ** -0.5)
    x_chunk = randn((t, d))
    x_rows = randn((rows, d))
    buf = ref.scatter_rows_ref(x_rows, recv_src, plan.total_rows)   # (R, d)
    h = randn((R, f)) * (torch.arange(R, device=dev) < live)[:, None]
    b2e, total = plan.block_to_expert, plan.total_rows
    wslot = torch.ones(R, device=dev)
    el = 2                                     # bf16 bytes per element
    # the ragged layout as a grouped GEMM's group ends: each expert's live
    # rows lie in one run of row blocks, in ascending expert order
    live_b2e = b2e[:live // BLOCK_M].long()
    if not bool((live_b2e[1:] >= live_b2e[:-1]).all()):
        raise SystemExit("the ragged plan's row blocks are not in expert order")
    offs = (torch.bincount(live_b2e, minlength=n_exp).cumsum(0) * BLOCK_M).to(torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        print(f"torch {torch.__version__} has no torch._grouped_mm: ragged_matmul "
              f"has no one-call yardstick here", flush=True)

    cases = {
        "scatter_rows": [
            (f"{tag}R={rows} T={t} d={d}", dc.scatter_rows,
             ref.scatter_rows_ref, (x_chunk, send_src, rows),
             # every row of the send buffer is live here, so index_select of
             # the source rows is the same function on these inputs
             lambda x, src, _: torch.index_select(x, 0, src),
             # each of the T source rows read once, the R rows written, the
             # row map read
             el * (t + rows) * d + 4 * rows, 0, 0.0),
            (f"{tag}R={R} T={rows} d={d}, slot weights, {recv_read} rows live "
             f"(combine backward)", dc.scatter_rows, ref.scatter_rows_ref,
             (x_rows, recv_src, total, wrow),
             None,                 # no one PyTorch call writes the zeros and the scale
             # the live rows read, every row written, the row map and the
             # weights read; one multiply per live element
             el * (recv_read + R) * d + (4 + el) * R, recv_read * d, 0.0)],
        "gather_combine": [
            (f"{tag}T={t} K={k} d={d} (EP combine)", dc.gather_combine,
             ref.gather_combine_ref,
             (x_rows, up.send_slots, weights),
             # every slot is live at one peer: a weighted sum bag of K rows
             lambda buf_, slots, w: F.embedding_bag(slots, buf_, mode="sum",
                                                    per_sample_weights=w),
             el * (t * k + t) * d, 2 * t * k * d, 1e-6),
            (f"{tag}T={rows} K=1 d={d} (fused backward dx)", dc.gather_combine,
             ref.gather_combine_ref, (buf, plan.slots),
             # every received row is live and K = 1: a row gather
             lambda buf_, slots: torch.index_select(buf_, 0, slots[:, 0]),
             el * 2 * rows * d, 0, 0.0)],
        "ragged_matmul": [
            (f"{tag}({R}, {d}) @ w1 ({d}, {f})", ragged_matmul,
             lambda a, w, *r: ref.ragged_matmul_ref(a, w, *r[:2]),
             (buf, w1, b2e, total, BLOCK_M),
             # the live rows as groups of a grouped GEMM (no rows past them)
             grouped_mm and (lambda a, w, *_: grouped_mm(a[:live], w, offs=offs)),
             el * (live * d + used * d * f + R * f), 2 * live * d * f, 1e-4),
            (f"{tag}({R}, {f}) @ w1^T ({f}, {d})",
             lambda a, w, *r: ragged_matmul(a, w, *r, transpose_w=True),
             lambda a, w, *r: ref.ragged_matmul_ref(a, w.transpose(1, 2), *r[:2]),
             (h, w1, b2e, total, BLOCK_M),
             grouped_mm and (lambda a, w, *_: grouped_mm(a[:live], w.transpose(1, 2),
                                                         offs=offs)),
             el * (live * f + used * d * f + R * d), 2 * live * d * f, 1e-4),
            (f"{tag}({R}, {f}) @ w2 ({f}, {d})", ragged_matmul,
             lambda a, w, *r: ref.ragged_matmul_ref(a, w, *r[:2]),
             (h, w2, b2e, total, BLOCK_M),
             grouped_mm and (lambda a, w, *_: grouped_mm(a[:live], w, offs=offs)),
             el * (live * f + used * f * d + R * d), 2 * live * d * f, 1e-4)],
        "ragged_swiglu": [(
            f"{tag}({R}, {d}) @ w1, w3 ({d}, {f})", ragged_swiglu,
            lambda a, u, v, *r: ref.ragged_swiglu_ref(a, u, v, *r[:2]),
            (buf, w1, w3, b2e, total, BLOCK_M),
            None,                      # no one PyTorch call computes it
            el * (live * d + 2 * used * d * f + R * f), 2 * 2 * live * d * f, 1e-4)],
        "fused_moe": [(
            f"{tag}T={rows} R={R} bm={BLOCK_M} E={n_exp} d={d} f={f}", fused_moe,
            lambda x, a, b, c, src, ws, tot, bb: ref.fused_moe_rows_ref(
                x, a, b, c, src, ws, bb, tot),
            (x_rows, w1, w3, w2, recv_src, wslot, total, b2e), None,
            el * (2 * rows * d + 3 * used * d * f), 3 * 2 * live * d * f, 1e-4)],
    }
    print(f"{tag}chunk routing: {live} of {R} ragged rows live, {used} experts used",
          flush=True)
    lay = types.SimpleNamespace(w1=w1, w3=w3, w2=w2, weights=weights, buf=buf, h=h,
                                b2e=b2e, total=total, live=live, offs=offs, used=used,
                                x_rows=x_rows, recv_src=recv_src)
    return cases, lay


def _run_cases(cases: dict) -> dict:
    """Each case's kernel against its plain version in fp32 and bf16 (the
    dispatch kernels bit for bit), the Hopper kernels and scatter_rows
    relaunched, then timed beside the plain version, the library yardstick
    where there is one, and the bound.  Returns {name: [row, ...]}."""
    import torch
    out = {}
    for name, shape_cases in cases.items():
        shapes = out.setdefault(name, [])
        for label, fn, plain, args32, library, nbytes, flops, tol32 in shape_cases:
            argsb = tuple(a.bfloat16() if torch.is_tensor(a) and a.is_floating_point()
                          else a for a in args32)
            got32, want32 = fn(*args32), plain(*args32)
            gotb, wantb = fn(*argsb), plain(*argsb)
            torch.cuda.synchronize()
            err32, errb = _max_err(got32, want32), _max_err(gotb, wantb)
            if tol32 == 0.0:
                ok = torch.equal(got32, want32) and torch.equal(gotb, wantb)
            else:
                ok = _close(got32, want32, tol32) and _close(gotb, wantb, TOL_BF16)
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version at {label}: "
                                 f"err bf16 {errb:.3e} f32 {err32:.3e}")
            if name in ("ragged_matmul", "ragged_swiglu", "fused_moe", "scatter_rows"):
                repeat_check(name, label, lambda: fn(*argsb), gotb)
            iters = 3 if flops > 1e11 else 10
            ms, host_ms, _ = device_ms(rotated(fn, argsb, nbytes), iters, kernel_call=True)
            plain_ms, plain_host, plain_note = device_ms(rotated(plain, argsb, nbytes), iters)
            lib_ms = lib_host = lib_err = None
            lib_note = ""
            if library is not None:
                try:
                    lib_out = library(*argsb)
                except (RuntimeError, NotImplementedError) as exc:
                    # a yardstick this PyTorch build does not offer at these
                    # inputs: reported, and the kernel's checks go on
                    print(f"{name} {label}: library call refused: "
                          f"{str(exc).splitlines()[0][:200]}", flush=True)
                else:
                    # the yardstick must compute the same function (on the
                    # rows it returns)
                    lib_want = wantb[:lib_out.shape[0]]
                    lib_err = _max_err(lib_out, lib_want)
                    if not _close(lib_out, lib_want, TOL_BF16):
                        raise SystemExit(f"{name}'s library yardstick disagrees with "
                                         f"the plain version at {label}: {lib_err:.3e}")
                    del lib_out, lib_want
                    lib_ms, lib_host, lib_note = device_ms(rotated(library, argsb, nbytes),
                                                           iters)
            bms, by = _bound(nbytes, flops)
            row = {"shape": label, "max_abs_err": errb, "max_abs_err_f32": err32,
                   "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": lib_ms}
            shapes.append(row)
            print(f"{name} {label}: ok err bf16 {errb:.3e} f32 {err32:.3e} | device ms: "
                  f"kernel {ms:.4f}, plain {plain_ms:.4f}{plain_note}, library "
                  f"{_fmt(lib_ms)}{lib_note}"
                  f"{'' if lib_err is None else f' (err {lib_err:.3e})'} | host ms per "
                  f"call: kernel {host_ms:.4f}, plain {plain_host:.4f}, library "
                  f"{_fmt(lib_host)} | bound {bms:.4f} ms ({by}), "
                  f"{100 * bms / ms:.1f}% of bound", flush=True)
            del got32, want32, gotb, wantb, argsb
    return out


def train_kernels_phase() -> dict:
    """Check and time the training paths' five kernels at their shapes;
    returns {kernel name: entry}."""
    phase("kernels (training path)")
    import torch
    import torch.nn.functional as F
    from repro_torch.core.dispatch import invert_slots
    from repro_torch.kernels import dispatch_cuda as dc
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_moe import fused_moe
    from repro_torch.kernels.ragged_mlp import ragged_matmul, ragged_swiglu

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    cases, lay = _chunk_cases(gen, dev, randn, T_CHUNK, E, TOP_K, D_MODEL, D_FF)
    w1, w3, w2, weights = lay.w1, lay.w3, lay.w2, lay.weights
    el = 2
    # the EP path's layouts: rank 0's received rows from 2 source blocks with
    # -1 gaps, over 4 local experts' weights (phase "train (EP, 2 ranks)")
    # and over 5 weight slots under a placement with a replica slot per rank
    # (phase "train (adaptive + placement, 2 ranks)")
    from repro_torch.core.placement import plan_placement
    layouts = []
    for spec, what in ((None, "EP rank"),
                       (plan_placement(PLACED_LOAD, EP_MESH[1], replicas=1),
                        "placed EP rank")):
        ep_plan, ep_rows, ep_R, ep_e, ep_send, experts = _ep_rank_layout(gen, dev, spec)
        ep_live = int(ep_plan.total_rows)
        ep_used = torch.unique(ep_plan.block_to_expert[:ep_live // BLOCK_M]).numel()
        ep_pos = invert_slots(ep_plan.slots, ep_R)
        ep_src = torch.where(ep_pos >= 0, ep_pos, -1).to(torch.int32)
        ep_read = int(((ep_src >= 0) & (torch.arange(ep_R, device=dev) < ep_live)).sum())
        ep_x = randn((ep_rows, D_MODEL))
        ep_buf = ref.scatter_rows_ref(ep_x, ep_src, ep_plan.total_rows)
        idx = torch.as_tensor(experts, device=dev)
        ep_w = tuple(w.index_select(0, idx) for w in (w1, w3, w2))
        ep_b2e, ep_total = ep_plan.block_to_expert, ep_plan.total_rows
        ep_label = (f"{what}: {ep_read} of {ep_rows} received rows live, R={ep_R}, "
                    f"E_local={ep_e}")
        if spec is not None:
            ep_label += f" (slots hold experts {experts})"
        cases["scatter_rows"].append((
            f"{ep_label} (receive dispatch)", dc.scatter_rows,
            ref.scatter_rows_ref, (ep_x, ep_src, ep_total), None,
            el * (ep_read + ep_R) * D_MODEL + 4 * ep_R, 0, 0.0))
        ep_t = ep_send.shape[0]
        cases["gather_combine"].append((
            f"{what}: T={ep_t} K={TOP_K} from {ep_rows} returned rows d={D_MODEL} "
            f"(EP combine)", dc.gather_combine, ref.gather_combine_ref,
            (ep_x, ep_send, weights[:ep_t]),
            lambda buf_, slots, w: F.embedding_bag(slots, buf_, mode="sum",
                                                   per_sample_weights=w),
            el * (ep_t * TOP_K + ep_t) * D_MODEL, 2 * ep_t * TOP_K * D_MODEL, 1e-6))
        cases["ragged_swiglu"].append((
            ep_label, ragged_swiglu,
            lambda a, u, v, *r: ref.ragged_swiglu_ref(a, u, v, *r[:2]),
            (ep_buf, ep_w[0], ep_w[1], ep_b2e, ep_total, BLOCK_M), None,
            el * (ep_live * D_MODEL + 2 * ep_used * D_MODEL * D_FF + ep_R * D_FF),
            2 * 2 * ep_live * D_MODEL * D_FF, 1e-4))
        cases["ragged_matmul"].append((
            f"{ep_label}, @ w1", ragged_matmul,
            lambda a, w, *r: ref.ragged_matmul_ref(a, w, *r[:2]),
            (ep_buf, ep_w[0], ep_b2e, ep_total, BLOCK_M), None,
            el * (ep_live * D_MODEL + ep_used * D_MODEL * D_FF + ep_R * D_FF),
            2 * ep_live * D_MODEL * D_FF, 1e-4))
        cases["fused_moe"].append((
            ep_label, fused_moe,
            lambda x, a, b, c, src, ws, tot, bb: ref.fused_moe_rows_ref(
                x, a, b, c, src, ws, bb, tot),
            (ep_x, *ep_w, ep_src, torch.ones(ep_R, device=dev), ep_total, ep_b2e), None,
            el * (2 * ep_rows * D_MODEL + 3 * ep_used * D_MODEL * D_FF),
            3 * 2 * ep_live * D_MODEL * D_FF, 1e-4))
        layouts.append((ep_buf, ep_b2e, ep_total, ep_live, ep_R, ep_e, ep_label))
        del ep_x, ep_w
    sources = {"scatter_rows": "dispatch.cu", "gather_combine": "dispatch.cu",
               "ragged_matmul": "ragged_mlp.cu", "ragged_swiglu": "ragged_mlp.cu",
               "fused_moe": "fused_moe.cu"}
    entries = {}
    for name, shapes in _run_cases(cases).items():
        head = shapes[0]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": REPLACES[name], "launches": 0,
            **{k: head[k] for k in ROW_KEYS},
            "shapes": shapes,
        }
    del cases, w1, w3, w2, weights
    tiles = tile_checks(lay, "")
    lay.w1 = lay.w3 = lay.w2 = lay.weights = lay.x_rows = None
    torch.cuda.empty_cache()
    entries["segment_outer"] = weight_grad_kernel(lay.buf, lay.h, lay.b2e, lay.total,
                                                  lay.live, lay.offs, gen)
    for name, rows in tiles.items():
        entries[name]["tiles"] = rows
    del lay
    torch.cuda.empty_cache()
    while layouts:
        ep_buf, ep_b2e, ep_total, ep_live, ep_R, ep_e, ep_label = layouts.pop(0)
        ep_h = randn((ep_R, D_FF)) * (torch.arange(ep_R, device=dev) < ep_live)[:, None]
        ep_offs = (torch.bincount(ep_b2e[:ep_live // BLOCK_M].long(), minlength=ep_e)
                   .cumsum(0) * BLOCK_M).to(torch.int32)
        entries["segment_outer"]["shapes"] += weight_grad_kernel(
            ep_buf, ep_h, ep_b2e, ep_total, ep_live, ep_offs, gen, n_experts=ep_e,
            tag=f"{ep_label}: ")["shapes"]
        del ep_buf, ep_h
        torch.cuda.empty_cache()
    return entries


SCOUT = "llama4-scout-17b-a16e"
SCOUT_KERNELS = ("scatter_rows", "gather_combine", "ragged_matmul", "fused_moe")


def scout_kernels(entries: dict, t_chunk: int) -> None:
    """The fused leg's kernels at Llama-4-Scout's MoE shapes (16 experts
    top-1, d_model 5120, d_ff 8192) and the ``t_chunk``-token chunk the
    train (families) run's MACT chose, at one peer as it ran: each against
    its plain version in fp32 and bf16, relaunched, timed beside the plain
    version, the library yardstick and the bound; the weight gradient at
    the same layout.  Rows join each kernel's ``shapes``."""
    phase("kernels (Llama-4-Scout)")
    import torch
    from repro_torch.configs import get_config

    cfg = get_config(SCOUT)
    n_exp, k, d, f = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    tag = "Llama-4-Scout "
    cases, lay = _chunk_cases(gen, dev, randn, t_chunk, n_exp, k, d, f, tag)
    cases = {name: cases[name] for name in SCOUT_KERNELS}
    for name, shapes in _run_cases(cases).items():
        entries[name]["shapes"] += [{"model": SCOUT, **row} for row in shapes]
    del cases
    for name, rows in tile_checks(lay, tag).items():
        entries[name]["tiles"] += [{"model": SCOUT, **row} for row in rows]
    lay.w1 = lay.w3 = lay.w2 = lay.weights = lay.x_rows = None
    torch.cuda.empty_cache()
    entries["segment_outer"]["shapes"] += [
        {"model": SCOUT, **row} for row in weight_grad_kernel(
            lay.buf, lay.h, lay.b2e, lay.total, lay.live, lay.offs, gen,
            n_experts=n_exp, tag=tag)["shapes"]]
    del lay
    torch.cuda.empty_cache()


TILES = (64, 128)       # the row tiles of the bf16 kernels with a runtime tile


@contextlib.contextmanager
def tile_search():
    """The autotuner's winners go to a cache file of their own while the
    tile checks search, so no later phase runs them: every other phase
    runs the default tiles, from the run's empty cache (``main``)."""
    from repro_torch.kernels import autotune
    run_cache = autotune.cache_path()
    autotune.set_cache_path(str(Path(run_cache).with_name("search.json")))
    try:
        yield
    finally:
        autotune.set_cache_path(run_cache)


def tile_checks(lay, tag: str) -> dict:
    """The three kernels with a runtime row tile at one FCDA chunk's layout
    (``_chunk_cases``' ``lay``), in bf16: ragged_matmul in both layouts
    (buf @ w1; h @ w1ᵀ, the backward's; h @ w2), fused_moe's down pass and
    segment_outer (dw1 = bufᵀ @ h and dw2 = hᵀ @ buf, written), each at tm
    64 and 128.  The two tiles' outputs must be bit-equal; each tile's
    device ms is printed beside the bound, then ``autotune()`` searches the
    two into the search cache (``tile_search``) and the line gives the
    default, the winner and each candidate's median ms.  Returns {kernel
    name: [row, ...]}."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.kernels.fused_moe import fused_moe
    from repro_torch.kernels.ragged_mlp import ragged_matmul
    from repro_torch.kernels.weight_grad import segment_outer

    buf, h, w1, w3, w2, x_rows = (t.bfloat16() for t in (lay.buf, lay.h, lay.w1, lay.w3,
                                                         lay.w2, lay.x_rows))
    b2e, total, live, used = lay.b2e, lay.total, lay.live, lay.used
    R, d = buf.shape
    f, E, rows = h.shape[1], w1.shape[0], x_rows.shape[0]
    wslot = torch.ones(R, dtype=torch.bfloat16, device=buf.device)
    el = 2

    def wgrad(a, b):
        out = torch.empty((E, a.shape[1], b.shape[1]), dtype=a.dtype, device=a.device)
        return lambda tm: segment_outer(a, b, b2e, total, BLOCK_M, out, accumulate=False,
                                        tm=tm)
    # (kernel, cache op, cache shape, label, fn(tm), bytes, flops)
    cases = [
        ("ragged_matmul", "ragged_matmul", (R, d, f, E, BLOCK_M), f"({R}, {d}) @ w1 ({d}, {f})",
         lambda tm: ragged_matmul(buf, w1, b2e, total, BLOCK_M, tm=tm),
         el * (live * d + used * d * f + R * f), 2 * live * d * f),
        ("ragged_matmul", "ragged_matmul_t", (R, f, d, E, BLOCK_M),
         f"({R}, {f}) @ w1^T ({f}, {d})",
         lambda tm: ragged_matmul(h, w1, b2e, total, BLOCK_M, transpose_w=True, tm=tm),
         el * (live * f + used * d * f + R * d), 2 * live * d * f),
        ("ragged_matmul", "ragged_matmul", (R, f, d, E, BLOCK_M), f"({R}, {f}) @ w2 ({f}, {d})",
         lambda tm: ragged_matmul(h, w2, b2e, total, BLOCK_M, tm=tm),
         el * (live * f + used * f * d + R * d), 2 * live * d * f),
        ("fused_moe", "fused_moe", (R, f, d, E, BLOCK_M),
         f"T={rows} R={R} bm={BLOCK_M} E={E} d={d} f={f}",
         lambda tm: fused_moe(x_rows, w1, w3, w2, lay.recv_src, wslot, total, b2e, tm=tm),
         el * (2 * rows * d + 3 * used * d * f), 3 * 2 * live * d * f),
        ("segment_outer", "segment_outer", (R, d, f, E, BLOCK_M),
         f"dw1 = bufᵀ @ h (E={E}, K={d}, N={f}), written", wgrad(buf, h),
         el * (live * (d + f) + E * d * f), 2 * live * d * f),
        ("segment_outer", "segment_outer", (R, f, d, E, BLOCK_M),
         f"dw2 = hᵀ @ buf (E={E}, K={f}, N={d}), written", wgrad(h, buf),
         el * (live * (d + f) + E * d * f), 2 * live * d * f)]
    out = {}
    for name, op, shape, label, fn, nbytes, flops in cases:
        default = _default_tile(op, shape)
        first = {tm: fn(tm).clone() for tm in TILES}
        torch.cuda.synchronize()
        if not autotune.bit_equal(first[64], first[128]):
            raise SystemExit(f"{name} {tag}{label}: tm 64 and tm 128 differ "
                             f"(max |diff| {_max_err(first[64], first[128]):.3e})")
        del first
        ms = {tm: device_ms(lambda: fn(tm), 3, kernel_call=True)[0] for tm in TILES}
        with tile_search():
            res = autotune.autotune(op, shape, torch.bfloat16, lambda tm: (lambda: fn(tm)),
                                    [{"tm": tm} for tm in TILES], baseline={"tm": default},
                                    device=buf.device)
        if res.skipped or res.refused:
            raise SystemExit(f"{name} {tag}{label}: the search skipped {res.skipped} and "
                             f"refused {res.refused}")
        bms, by = _bound(nbytes, flops)
        search = {c["tm"]: m for c, m in res.table}
        out.setdefault(name, []).append({
            "shape": f"{tag}{label}", "key": [op, *shape], "default_tm": default,
            "winner_tm": res.winner["tm"], "ms_by_tm": ms, "search_ms_by_tm": search,
            "spread_ms": res.spread_ms,
            "bound_ms": bms, "bound_by": by})
        print(f"tiles {name} {tag}{label}: tm 64 and 128 bit-equal | device ms: tm 64 "
              f"{ms[64]:.4f} ({100 * bms / ms[64]:.1f}% of bound), tm 128 {ms[128]:.4f} "
              f"({100 * bms / ms[128]:.1f}%) | bound {bms:.4f} ms ({by})", flush=True)
        print(f"autotune {op} {'x'.join(map(str, shape))} bf16: default tm {default}, "
              f"winner tm {res.winner['tm']} (x{res.speedup_vs_baseline:.3f} of the "
              f"default); median ms: "
              + ", ".join(f"tm {tm} {search[tm]:.4f}" for tm in TILES)
              + f"; a winner must beat the default by the blocks' spread, "
              f"{res.spread_ms:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return out


def _wgrad_close(got, want, s=None) -> bool:
    """The weight gradient against its plain version, the same products
    summed in fp32 in other orders.  fp32: 1e-5 of the largest magnitude (a
    sum of ~600 products drifts by ~sqrt(n) eps of its terms, however small
    the sum).  bf16: one ulp, 1e-2 absolute and relative, and when adding
    into the buffer (``s``: the bf16 sum) the sum's own ulp on top: it is
    rounded to bf16 before the add."""
    import torch
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-5 * (want.abs().max() + want.abs())).all())
    bound = TOL_BF16 * (1 + want.float().abs())
    if s is not None:
        bound += TOL_BF16 * s.float().abs()
    return bool((err <= bound).all())


def weight_grad_kernel(buf, h, b2e, total, live: int, offs, gen, n_experts: int = E,
                       tag: str = "") -> dict:
    """The expert weights' gradient (``segment_outer``) at the path's three
    calls per chunk, dw1 / dw3 = bufᵀ @ dh (E, d, f) and dw2 = aᵀ @ g_buf
    (E, f, d), written (a layer's first chunk) and added into the buffer
    (every later one): checked against the plain version in fp32 and bf16,
    relaunched, and timed beside the plain version, its bound and
    ``torch._grouped_mm``'s 2-D x 2-D form (groups along the rows) where
    this PyTorch has it.  ``n_experts`` weight slices, ``tag`` before each
    label.  Returns the kernel's entry."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.weight_grad import segment_outer

    dev = buf.device
    R, d = buf.shape
    f = h.shape[1]
    liverows = (torch.arange(R, device=dev) < live)[:, None]
    g_buf = torch.randn((R, d), generator=gen, device=dev) * liverows
    grouped_mm = getattr(torch, "_grouped_mm", None)
    el = 2
    shapes = []
    # (label, a, b, out (E, K, N), accumulate)
    cases = [(tag + "dw1 = bufᵀ @ dh1, written", buf, h, (n_experts, d, f), False),
             (tag + "dw1 = bufᵀ @ dh1, added", buf, h, (n_experts, d, f), True),
             (tag + "dw2 = aᵀ @ g_buf, added", h, g_buf, (n_experts, f, d), True)]
    for label, a32, b32, oshape, acc in cases:
        K, N = oshape[1], oshape[2]
        # on the path the buffer holds an earlier chunk's gradient, of the new
        # sum's size: drawn at the sum's spread, a dropped or doubled add is
        # off by ~|sum|, far above the tolerance
        sum32 = ref.segment_outer_ref(a32, b32, b2e, total,
                                      torch.empty(oshape, device=dev), False)
        old32 = torch.randn(oshape, generator=gen, device=dev) * sum32.std()
        del sum32
        outs = {}
        blind = ""
        for dt in (torch.float32, torch.bfloat16):
            a, b, old = a32.to(dt), b32.to(dt), old32.to(dt)
            got = segment_outer(a, b, b2e, total, BLOCK_M, old.clone(), accumulate=acc)
            want = ref.segment_outer_ref(a, b, b2e, total, old.clone(), acc)
            s = (ref.segment_outer_ref(a, b, b2e, total, torch.empty_like(old), False)
                 if acc and dt == torch.bfloat16 else None)
            torch.cuda.synchronize()
            outs[dt] = (_max_err(got, want), _wgrad_close(got, want, s))
            if s is not None:
                # the check must reject a kernel that skips the add or adds twice
                doubled = (want.float() + old.float()).to(dt)
                skip_err, twice_err = _max_err(s, want), _max_err(doubled, want)
                if _wgrad_close(s, want, s) or _wgrad_close(doubled, want, s):
                    raise SystemExit(f"segment_outer's check at {label} accepts a kernel "
                                     f"that skips the add ({skip_err:.3e}) or adds twice "
                                     f"({twice_err:.3e})")
                blind = (f" (a skipped add would be off by {skip_err:.3e}, a doubled one "
                         f"by {twice_err:.3e}: both rejected)")
                del doubled
            del got, want, s
        (err32, ok32), (errb, okb) = outs[torch.float32], outs[torch.bfloat16]
        if not (ok32 and okb):
            raise SystemExit(f"segment_outer disagrees with its plain version at {label}: "
                             f"err bf16 {errb:.3e} f32 {err32:.3e}")
        a, b, old = a32.bfloat16(), b32.bfloat16(), old32.bfloat16()
        out = old.clone()
        first = segment_outer(a, b, b2e, total, BLOCK_M, old.clone(), accumulate=acc)
        repeat_check("segment_outer", label, lambda: segment_outer(
            a, b, b2e, total, BLOCK_M, old.clone(), accumulate=acc), first)
        del first
        # timed in place, as the path calls it (adding: out grows, harmlessly)
        ms, host_ms, _ = device_ms(lambda: segment_outer(a, b, b2e, total, BLOCK_M, out,
                                                         accumulate=acc), 5, kernel_call=True)
        plain_ms, plain_host, plain_note = device_ms(
            lambda: ref.segment_outer_ref(a, b, b2e, total, out, acc), 3)
        lib_ms = lib_host = lib_err = None
        lib_note = ""
        if grouped_mm is not None and not acc:
            try:
                lib_out = grouped_mm(a[:live].T, b[:live], offs=offs)
            except (RuntimeError, NotImplementedError) as exc:
                print(f"segment_outer {label}: library call refused: "
                      f"{str(exc).splitlines()[0][:200]}", flush=True)
            else:
                want = ref.segment_outer_ref(a, b, b2e, total, old.clone(), False)
                lib_err = _max_err(lib_out, want)
                if not _close(lib_out, want, TOL_BF16):
                    raise SystemExit(f"segment_outer's library yardstick disagrees with "
                                     f"the plain version at {label}: {lib_err:.3e}")
                del lib_out, want
                lib_ms, lib_host, lib_note = device_ms(
                    lambda: grouped_mm(a[:live].T, b[:live], offs=offs), 5)
        # the live rows of a and b read once, the output written once (and,
        # adding, read once); the products over the live rows
        nbytes = el * (live * (K + N) + (2 if acc else 1) * n_experts * K * N)
        bms, by = _bound(nbytes, 2 * live * K * N)
        row = {"shape": label, "max_abs_err": errb, "max_abs_err_f32": err32, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
               "library_ms": lib_ms}
        shapes.append(row)
        print(f"segment_outer {label} (R={R}, {live} live, E={n_experts}, K={K}, N={N}): ok err "
              f"bf16 {errb:.3e} f32 {err32:.3e} | device ms: kernel {ms:.4f}, plain "
              f"{plain_ms:.4f}{plain_note}, library {_fmt(lib_ms)}{lib_note}"
              f"{'' if lib_err is None else f' (err {lib_err:.3e})'}{blind} | host ms per call: "
              f"kernel {host_ms:.4f}, plain {plain_host:.4f}, library {_fmt(lib_host)} | "
              f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of bound", flush=True)
        del a, b, old, out, old32
        torch.cuda.empty_cache()
    head = shapes[0]       # written: the one form a library call computes
    return {"name": "segment_outer", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/weight_grad.cu",
            "replaces": "src/repro/kernels/ops.py:158",
            "note": "not a pallas_call: mirrors the JAX package's lax.scan",
            "launches": 0, **{k: head[k] for k in ROW_KEYS}, "shapes": shapes}


def attention_kernels_phase() -> dict:
    """Check and time flash attention at Mixtral-8x7B's attention shapes; no
    model calls it (as in the JAX package), so it has no launches on a
    path.  Returns {"flash_attention": entry}."""
    phase("kernels (attention)")
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    shapes = []
    for BH, S, causal, window in ATTN_SHAPES:
        q, k, v = (torch.randn((BH, S, HEAD_DIM), generator=gen, device=dev)
                   for _ in range(3))
        mask = ref.attention_mask(S, S, causal, window, dev)
        pairs = int(mask.sum())                     # the visible (query, key) pairs
        # the yardstick: one SDPA call, the band as a boolean mask where the
        # window cuts (is_causal where it does not)
        cut = bool(window) and window < S
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and S > ATTN_SHAPES[0][1]:
                continue
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            el = qd.element_size()
            label = (f"BH={BH} S={S} hd={HEAD_DIM} causal={causal} window={window} "
                     f"{str(dtype).split('.')[1]}")

            def kernel():
                return flash_attention(qd, kd, vd, causal=causal, window=window)

            def plain():
                return ref.flash_attention_ref(qd, kd, vd, causal=causal, window=window)

            def library():
                # (1, BH, S, hd) views: SDPA's fused backends take 4-d inputs
                if cut:
                    out = F.scaled_dot_product_attention(qd[None], kd[None], vd[None],
                                                         attn_mask=mask)
                else:
                    out = F.scaled_dot_product_attention(qd[None], kd[None], vd[None],
                                                         is_causal=causal)
                return out[0]

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_ATTN_F32
            ok = _close(got, want, tol)
            if ok and dtype == torch.bfloat16:
                repeat_check("flash_attention", label, kernel, got)
            lib_out = library()
            lib_err = _max_err(lib_out, want)
            if not _close(lib_out, want, TOL_BF16):
                raise SystemExit(f"the SDPA yardstick disagrees with the plain version "
                                 f"at {label}: {lib_err:.3e}")
            del got, want, lib_out
            iters = 3 if S > 4096 else 10
            ms, host_ms, _ = device_ms(kernel, iters, kernel_call=True)
            plain_ms, plain_host, plain_note = device_ms(plain, 3)
            lib_ms, lib_host, lib_note = device_ms(library, iters)
            # q, k, v read once and out written once; QKᵀ and P·V over the
            # visible pairs, at the bf16 tensor rate (fp32: the CUDA-core rate)
            bms, by = _bound(el * 4 * BH * S * HEAD_DIM, 4 * HEAD_DIM * pairs * BH,
                             BF16_FLOPS if el == 2 else FP32_FLOPS)
            row = {"shape": label, "max_abs_err": err, "ms": ms, "host_ms": host_ms,
                   "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                   "library_ms": lib_ms}
            shapes.append(row)
            print(f"flash_attention {label}: {'ok' if ok else 'MISMATCH'} err {err:.3e} "
                  f"(tol {tol}) | device ms: kernel {ms:.4f}, plain {plain_ms:.4f}"
                  f"{plain_note}, SDPA {lib_ms:.4f}{lib_note} (err {lib_err:.3e}) | host "
                  f"ms per call: kernel "
                  f"{host_ms:.4f}, plain {plain_host:.4f}, SDPA {lib_host:.4f} | bound "
                  f"{bms:.4f} ms ({by}, {pairs} pairs x {BH}), "
                  f"{100 * bms / ms:.1f}% of bound", flush=True)
            if not ok:
                raise SystemExit(f"flash_attention disagrees with its plain version at "
                                 f"{label}")
        del q, k, v, mask
        torch.cuda.empty_cache()
    head = shapes[0]
    return {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76", "launches": 0,
        **{k: head[k] for k in ROW_KEYS},
        "shapes": shapes}}


# device kernels of a training step by group, from their names in the
# profiler (bf16 ragged_matmul, ragged_swiglu and fused_moe's up and down
# passes are the Hopper mainloop, named by their epilogues)
STEP_GROUPS = {"fused_moe": ("FusedUpStore", "FusedCombine"),
               "ragged_swiglu": ("SwigluStore",),
               "ragged_matmul": ("RaggedStore",),
               "segment_outer": ("weight_grad_wgmma",),
               "dispatch": ("scatter_rows", "gather_combine")}
# the serving kernels by their names in the profiler: bf16 runs the weight
# stream (grouped_wgmma<number of weights>), fp32 the tile loop
SERVE_GROUPS = {"grouped_swiglu": ("grouped_wgmma<2>", "grouped_kernel<2>"),
                "grouped_matmul": ("grouped_wgmma<1>", "grouped_kernel<1>")}


def device_kernels(prof) -> list:
    """[(name, launches, device us)] of a finished torch.profiler run's
    device activities (kernels, copies, sets), summed from its raw Kineto
    events.  key_averages() gives the same sums but first builds every host
    op's event tree in Python, ~17 s per 200k events on a host core: most
    of a profiled eager serve run's time."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = out.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e3
    return [(k, n, us) for k, (n, us) in out.items() if us > 0]


def profile_step(trainer, state) -> None:
    """One more, warm step under the profiler: the step-time breakdown."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(1, state)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(r[2] for r in rows)
    # the serving phases sum the raw events instead: they must agree here
    raw_us = sum(r[2] for r in device_kernels(prof))
    if abs(raw_us - device_us) > 0.01 * device_us:
        raise SystemExit(f"device_kernels reads {raw_us / 1e3:.3f} ms of device time "
                         f"where key_averages reads {device_us / 1e3:.3f}")
    by_group = {g: sum(r[2] for r in rows if any(k in r[0] for k in keys))
                for g, keys in STEP_GROUPS.items()}
    print(f"profiled warm step: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{device_us / 1e3:.1f} ms (idle {100 - 100 * device_us / wall_us:.1f}%); "
          + ", ".join(f"{g} {us / 1e3:.1f} ms" for g, us in by_group.items())
          + f", everything else {(device_us - sum(by_group.values())) / 1e3:.1f} ms",
          flush=True)
    for key, count, us in sorted(rows, key=lambda r: -r[2])[:15]:
        print(f"  {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def report_training(trainer, wall: float, launches: dict, steps: int) -> dict:
    """Print a training run's steps, peak memory and MACT's model of it;
    fail on a non-finite loss or grad norm, or a kernel of the path that
    never launched.  Returns MACT's memory report at the last schedule."""
    import math

    peak = trainer.max_memory_allocated       # over the run's attempts
    for r in trainer.log:
        print(f"step {r['step']}: loss {r['loss']:.6f} (ce {r['ce']:.6f}, aux "
              f"{r['aux']:.6f}), grad_norm {r['grad_norm']:.4f}, schedule "
              f"(chunks {r['chunks']}, depth {r['pipeline']}), {r['time_s']:.3f} s, "
              f"{r['tgs']:.1f} tokens/s, max_load {r['max_load']:.0f}, "
              f"drops {r['drops']:.0f}", flush=True)
    s_pp = trainer.mact.history[-1]["s_pp"]
    last = trainer.log[-1]
    report = trainer.mact.memory_report(s_pp, last["chunks"], last["pipeline"])
    print(f"phase {wall:.1f} s (weights built on the card included); "
          f"max_memory_allocated {peak / 1e9:.2f} GB against ~{PLAIN_TRAIN_GB:.0f} GB "
          f"reckoned; MACT's model (fused={trainer.mact.fused}): static "
          f"{report['static_gb'] * 2**30 / 1e9:.2f} GB + activations "
          f"{report['activation_gb'] * 2**30 / 1e9:.2f} GB = "
          f"{report['total_gb'] * 2**30 / 1e9:.2f} GB, s'max {report['s_prime_max']:.0f}",
          flush=True)
    print(f"launches {launches} over {len(trainer.log)} steps", flush=True)
    bad = [r for r in trainer.log
           if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
    if bad or len(trainer.log) != steps:
        raise SystemExit(f"training gave non-finite losses or grad norms: {bad}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"{name} never launched on the training path")
    return report


def fwd_bwd_peaks(trainer, state, who: str = "", placements=None) -> tuple:
    """The peak of one forward + backward (no optimizer) above what is
    already allocated, at MACT's (chunks, depth), at (2, 1) and at (1, 1)
    (each under ``placements``, a placement vector, when given),
    beside MACT's modeled activation bytes for the trainer's leg (Eq. 2;
    fused=False keeps the dispatch buffer's 2h term), on this rank's rows of
    the step's batch.  Returns {schedule: peak bytes} and the card's memory
    in use (all processes) just after the last backward."""
    import torch
    from repro_torch.optim.adamw import param_list
    from repro_torch.training.step import loss_fn

    s_pp = trainer.mact.history[-1]["s_pp"]
    s_pp = max(s_pp) if isinstance(s_pp, list) else s_pp     # per layer: the binding one
    batch = {k: torch.as_tensor(v[trainer._rows], device=trainer.ctx.device)
             for k, v in trainer.data.batch_at(0).items()}
    leaves = param_list(state.params)
    schedules = dict.fromkeys(((trainer.log[-1]["chunks"], trainer.log[-1]["pipeline"]),
                               (2, 1), (1, 1)))
    peaks = {}
    for chunks, depth in schedules:
        modeled = trainer.mact.memory_report(s_pp, chunks, depth)["activation_gb"] * 2**30
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        key = (chunks, depth) if placements is None else ((chunks, depth), placements)
        loss, _ = loss_fn(state.params, trainer.cfg, trainer._context_for(key)[1], batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        free, total = torch.cuda.mem_get_info()
        grad_bytes = sum(g.numel() * g.element_size() for g in grads if g is not None)
        peaks[chunks, depth] = peak
        del loss, grads
        print(f"{who}forward + backward at (chunks {chunks}, depth {depth}), fused="
              f"{trainer.mact.fused}: peak {peak / 1e9:.3f} GB above the "
              f"{base / 1e9:.2f} GB allocated, of which the bf16 gradients "
              f"{grad_bytes / 1e9:.3f} GB; the rest {(peak - grad_bytes) / 1e9:.3f} GB "
              f"against MACT's modeled activations {modeled / 1e9:.3f} GB "
              f"(s'' {s_pp:.0f})", flush=True)
    return peaks, total - free


def check_peaks(peaks: dict, who: str = "") -> None:
    """FCDA exists to lower the peak: two sequential chunks above one
    chunk's fails the run."""
    if peaks[2, 1] > peaks[1, 1]:
        raise SystemExit(f"{who}two sequential chunks raise the forward + backward "
                         f"peak: {peaks[2, 1] / 1e9:.3f} GB at (2, 1) against "
                         f"{peaks[1, 1] / 1e9:.3f} GB at (1, 1)")


def train_phase() -> dict:
    """Drive the port's training entry point; returns the four kernels'
    launch counts from this run."""
    phase("train")
    import torch
    from repro_torch.kernels import dispatch_cuda as dc
    from repro_torch.kernels.fused_moe import fused_moe
    from repro_torch.kernels.ragged_mlp import ragged_matmul
    from repro_torch.kernels.weight_grad import segment_outer
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = (dc.scatter_rows, dc.gather_combine, ragged_matmul, fused_moe,
                segment_outer)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    trainer, state = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    wall = time.perf_counter() - t0
    report_training(trainer, wall, launches, 4)
    ce = trainer.log[0]["ce"]
    profile_step(trainer, state)
    check_peaks(fwd_bwd_peaks(trainer, state)[0])
    forced_tiles_check(trainer, state)
    del trainer, state
    torch.cuda.empty_cache()
    return launches, ce


def _default_tile(op: str, shape: tuple) -> int:
    """The row tile a kernel's wrapper launches at ``shape`` (R, K, N, E,
    bm) in bf16 when no ``tm`` is given and its cache holds nothing: the
    wrapper's own rule, read from the run's cache, which stays empty."""
    import torch
    from repro_torch.kernels import autotune, ragged_mlp, weight_grad
    if autotune.lookup(op, shape, torch.bfloat16) is not None:
        raise SystemExit(f"the run's tile cache holds {op} at {shape}")
    if op == "segment_outer":
        return weight_grad.tuned_row_tile(shape, torch.bfloat16)
    return ragged_mlp.tuned_row_tile(op, shape, shape[4])


def _other_tile(op: str, shape: tuple):
    """The row tile a kernel with a runtime tile takes at ``shape`` (R, K,
    N, E, bm) besides its default, or None."""
    from repro_torch.kernels.ragged_mlp import row_tile
    if op == "segment_outer":
        return 64 if shape[1] > 64 else None
    bm = shape[4]
    other = row_tile(bm)
    return other if other != row_tile(bm, wide=True) else None


def forced_tiles_check(trainer, state) -> None:
    """One forward + backward of the trainer's model (full-width Mixtral at
    2 layers) at MACT's schedule, from one state and one batch, twice: with
    the default tiles (the run's empty cache), then under a cache that gives
    every (op, shape) the first run looked up the other row tile.  Every
    lookup of the second run must have returned it, and the loss and every
    gradient must be bit-equal."""
    import torch
    from repro_torch.kernels import autotune
    from repro_torch.optim.adamw import param_list
    from repro_torch.training.step import loss_fn

    chunks, depth = trainer.log[-1]["chunks"], trainer.log[-1]["pipeline"]
    ctx = trainer._context_for((chunks, depth))[1]
    batch = {k: torch.as_tensor(v[trainer._rows], device=ctx.device)
             for k, v in trainer.data.batch_at(0).items()}
    leaves = param_list(state.params)
    run_cache, lookup = autotune.cache_path(), autotune.lookup
    seen: dict = {}

    def spy(op, shape, dtype):
        got = lookup(op, shape, dtype)
        seen.setdefault((op, tuple(shape), dtype), []).append(got)
        return got

    autotune.lookup = spy
    try:
        loss, _ = loss_fn(state.params, trainer.cfg, ctx, batch)
        want = (loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True))
        del loss
        first = dict(seen)
        if not first or any(v != [None] * len(v) for v in first.values()):
            raise SystemExit(f"the default run looked up {len(first)} tiles, or found "
                             f"one in the run's cache")
        forced = {}
        autotune.set_cache_path(str(Path(run_cache).with_name("forced.json")))
        for (op, shape, dtype) in first:
            forced[op, shape] = _other_tile(op, shape)
            if forced[op, shape] is None:
                raise SystemExit(f"{op} at {shape} has no other row tile to force")
            autotune.record(op, shape, dtype, {"tm": forced[op, shape]})
        seen.clear()
        loss, _ = loss_fn(state.params, trainer.cfg, ctx, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
    finally:
        autotune.lookup = lookup
        autotune.set_cache_path(run_cache)
    if {k: len(v) for k, v in seen.items()} != {k: len(v) for k, v in first.items()} or any(
            got != {"tm": forced[op, shape]} for (op, shape, _), v in seen.items()
            for got in v):
        raise SystemExit("the forced run did not take the forced tile at every lookup")
    same = torch.equal(loss.detach(), want[0]) and all(
        (g is None and w is None) or (g is not None and w is not None and torch.equal(g, w))
        for g, w in zip(grads, want[1]))
    by_op: dict = {}
    for (op, shape), tm in forced.items():
        by_op.setdefault(op, []).append(f"{'x'.join(map(str, shape))}: tm {tm}")
    print(f"forward + backward at (chunks {chunks}, depth {depth}) under forced tiles "
          f"({sum(len(v) for v in seen.values())} launches over {len(forced)} (op, shape) "
          f"keys: " + "; ".join(f"{op} {', '.join(v)}" for op, v in by_op.items())
          + f"): loss {float(loss.detach()):.6f} and {sum(g is not None for g in grads)} gradients "
          f"{'bit-equal to' if same else 'DIFFER from'} the default tiles'", flush=True)
    if not same:
        raise SystemExit("a forced row tile changed the loss or a gradient")


def train_ragged_phase() -> dict:
    """Train on the three-launch ragged leg through Trainer, built as
    launch/train.py::main builds it (its CLI has no flag for this leg, as
    the JAX launcher has none); returns the path's launch counts."""
    phase("train (ragged leg)")
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.kernels import dispatch_cuda as dc
    from repro_torch.kernels.fused_moe import fused_moe
    from repro_torch.kernels.ragged_mlp import ragged_matmul, ragged_swiglu
    from repro_torch.kernels.weight_grad import segment_outer
    from repro_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = (dc.scatter_rows, dc.gather_combine, ragged_swiglu, ragged_matmul,
                segment_outer)
    for fn in (*counters, fused_moe):
        fn.launches = 0
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=2)
    ctx = DistContext(device=torch.device("cuda"), moe_strategy="ep_shardmap",
                      moe_ragged=True)
    trainer = Trainer(cfg, ctx, seq_len=2048, global_batch=2, lr=1e-4, seed=0,
                      dtype=torch.bfloat16, use_mact=True, max_pipeline_depth=2)
    state = trainer.fit(RAGGED_STEPS)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    wall = time.perf_counter() - t0
    report = report_training(trainer, wall, launches, RAGGED_STEPS)
    if fused_moe.launches:
        raise SystemExit(f"fused_moe launched {fused_moe.launches} times on the "
                         f"ragged leg")
    profile_step(trainer, state)
    check_peaks(fwd_bwd_peaks(trainer, state)[0])
    print(f"MACT on the ragged leg: s'max {report['s_prime_max']:.0f}, schedule "
          f"(chunks {trainer.log[-1]['chunks']}, depth {trainer.log[-1]['pipeline']})",
          flush=True)
    del trainer, state
    torch.cuda.empty_cache()
    return launches


# the EP phase: the same model, steps and batch as the train phase on a 1 x 2
# mesh, both ranks on the one card over gloo (each rank: 4 of the 8 experts
# of each layer, one of the two 2048-token sequences)
EP_MESH, EP_RANKS = (1, 2), 2
EP_LABEL = "2 ranks time-sharing one card, exchange staged through the host by gloo"
EP_TIMEOUT_S = 600
# the kernels each leg must launch on every rank
EP_KERNELS = {"fused": ("scatter_rows", "gather_combine", "ragged_matmul", "fused_moe",
                        "segment_outer"),
              "ragged": ("scatter_rows", "gather_combine", "ragged_swiglu",
                         "ragged_matmul", "segment_outer")}


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _exchange_ms(trainer, mesh) -> tuple:
    """(rows per peer block, ms) of one dispatch-sized exchange, bf16, at
    the trainer's last schedule: cap_send = t_c min(k, E_local) rows."""
    import torch
    cfg = trainer.cfg
    tokens = (trainer._rows.stop - trainer._rows.start) * trainer.seq_len
    e_local = cfg.moe.num_experts // mesh.peers
    cap = tokens // trainer.log[-1]["chunks"] * min(cfg.moe.top_k, e_local)
    x = torch.randn((mesh.peers, cap, cfg.d_model), device=trainer.ctx.device,
                    dtype=torch.bfloat16)
    for _ in range(2):
        mesh.all_to_all(x)
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(10):
        mesh.all_to_all(x)
    torch.cuda.synchronize()
    return cap, 1e3 * (time.perf_counter() - t0) / 10


def _split_steps(spans: list, events: list, kinds=("exchange", "all_reduce")) -> list:
    """Each step's wall seconds, and the host seconds, calls and bytes of
    each kind of its collectives (exchanges and all-reduces)."""
    out = []
    for t0, t1 in spans:
        step = {"wall": t1 - t0}
        for kind in kinds:
            mine = [e for e in events if e[2] == kind and t0 <= e[0] < t1]
            step[kind] = {"s": sum(e[1] for e in mine), "calls": len(mine),
                          "bytes": sum(e[3] for e in mine)}
        out.append(step)
    return out


def _ep_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of the EP phase, in a process of its own, started as
    torchrun starts one: launch/train.py reads the world from the
    environment.  Trains the fused leg through the entry point, then the
    ragged leg through Trainer on the same mesh, and writes what it saw to
    out_dir/rank<r>.json."""
    import gc
    import os
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(EP_RANKS),
                      LOCAL_WORLD_SIZE=str(EP_RANKS), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.kernels._cuda import wrappers
    from repro_torch.launch import train
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    # measurement only: the host time inside each collective that runs
    # (launch/mesh.py skips a group of one rank), and each step's span, so
    # each step splits into exchanges, all-reduces and the rest (gloo
    # returns once the collective is done)
    events, spans = [], []

    def timed(kind, real):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            t = args[-1] if kind == "exchange" else args[0]
            events.append((t0, time.perf_counter() - t0, kind,
                           t.numel() * t.element_size()))
            return out
        return call

    dist.all_to_all_single = timed("exchange", dist.all_to_all_single)
    dist.all_reduce = timed("all_reduce", dist.all_reduce)
    real_step = trainer_mod.make_train_step

    def make_step(*args, **kw):
        step = real_step(*args, **kw)

        def run(state, batch):
            t0 = time.perf_counter()
            out = step(state, batch)
            float(out[1]["loss"])              # the trainer's own sync point
            spans.append((t0, time.perf_counter()))
            return out
        return run

    trainer_mod.make_train_step = make_step
    rec = {"rank": rank}
    try:
        for leg in ("fused", "ragged"):
            for fn in wrappers():
                fn.launches = 0
            events.clear()
            spans.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if leg == "fused":
                trainer, state = train.main(TRAIN_ARGS + ["--mesh", "x".join(
                    map(str, EP_MESH))])
                # the ragged leg: the same model, mesh and steps through Trainer
                kw = {k: getattr(trainer, k) for k in ("seq_len", "global_batch", "lr",
                                                       "seed", "dtype",
                                                       "max_pipeline_depth")}
                cfg = trainer.cfg
                ctx = dataclasses.replace(trainer.ctx, moe_fused=False, moe_ragged=True)
            else:
                trainer = Trainer(cfg, ctx, **kw)
                state = trainer.fit(RAGGED_STEPS)
            mesh = trainer.ctx.mesh
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            free, total = torch.cuda.mem_get_info()
            launches = {fn.__name__: fn.launches for fn in wrappers()}
            s_pp = trainer.mact.history[-1]["s_pp"]
            report = trainer.mact.memory_report(s_pp, trainer.log[-1]["chunks"],
                                                trainer.log[-1]["pipeline"])
            out = {"log": trainer.log, "chunks": trainer.chunk_trace,
                   "pipeline": trainer.pipeline_trace, "wall_s": wall,
                   "max_memory_allocated": trainer.max_memory_allocated,
                   "modeled_bytes": report["total_gb"] * 2**30,
                   "modeled_static_bytes": report["static_gb"] * 2**30,
                   "card_in_use_after_steps": total - free,
                   "launches": launches, "steps": _split_steps(spans, events),
                   "par": [trainer.par.e, trainer.par.b], "d_model": cfg.d_model}
            out["exchange_rows"], out["exchange_ms"] = _exchange_ms(trainer, mesh)
            peaks, used = fwd_bwd_peaks(trainer, state, who=f"rank {rank} ({leg} leg): ")
            out["peaks"] = {f"{c},{d}": v for (c, d), v in peaks.items()}
            out["card_in_use_after_backward"] = used
            rec[leg] = out
            del trainer, state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(target, n: int, args: tuple, timeout: float) -> None:
    """Start ``target(rank, *args)`` in n spawned processes (CUDA cannot be
    forked) and wait for all of them; a rank that fails or hangs fails the
    phase, and every rank still running is killed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise SystemExit(f"ranks exited with {codes} (None: killed after {timeout:.0f} s)")


def train_ep_phase(one_peer_ce: float) -> dict:
    """Drive launch/train.py on a 1x2 mesh, 2 ranks on the one card over
    gloo, on the fused leg, then the ragged leg through Trainer; returns
    the path's launch counts, summed over ranks and legs."""
    phase("train (EP, 2 ranks)")
    import gc
    import math
    import tempfile

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"before spawning: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB ({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved); the card has "
          f"{(total - free) / 1e9:.2f} of {total / 1e9:.2f} GB in use", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _run_ranks(_ep_rank, EP_RANKS, (_free_port(), tmp), EP_TIMEOUT_S)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(EP_RANKS)]
    print(f"phase {time.perf_counter() - t0:.1f} s (rank start-up and weights included)",
          flush=True)
    launches, used = {}, []
    for leg in ("fused", "ragged"):
        recs = [r[leg] for r in ranks]
        first = recs[0]
        for step in first["log"]:
            recv = step["recv_by_peer"]
            busy = max(range(len(recv)), key=recv.__getitem__)
            print(f"{leg} leg, step {step['step']}: loss {step['loss']:.6f} (ce "
                  f"{step['ce']:.6f}, aux {step['aux']:.6f}), grad_norm "
                  f"{step['grad_norm']:.4f}, schedule (chunks {step['chunks']}, depth "
                  f"{step['pipeline']}), {step['time_s']:.3f} s, {step['tgs']:.1f} tokens/s "
                  f"({EP_LABEL}); received token-slots: rank {busy} {recv[busy]:.0f} "
                  f"(busier) against {', '.join(f'rank {j} {v:.0f}' for j, v in enumerate(recv) if j != busy)}; "
                  f"drops {step['drops']:.0f}", flush=True)
        for r, rec in enumerate(recs):
            print(f"{leg} leg, rank {r}: Parallelism(e={rec['par'][0]}, b={rec['par'][1]}); "
                  f"max_memory_allocated {rec['max_memory_allocated'] / 1e9:.2f} GB against "
                  f"MACT's modeled per-rank {rec['modeled_bytes'] / 1e9:.2f} GB (static "
                  f"{rec['modeled_static_bytes'] / 1e9:.2f}); forward + backward peaks "
                  + ", ".join(f"({k}) {v / 1e9:.3f} GB" for k, v in rec["peaks"].items())
                  + f"; one ({EP_MESH[1]}, {rec['exchange_rows']}, {rec['d_model']}) bf16 "
                  f"exchange {rec['exchange_ms']:.2f} ms on gloo; launches "
                  f"{ {k: n for k, n in rec['launches'].items() if n} }", flush=True)
            for i, st in enumerate(rec["steps"], 1):
                ex, ar = st["exchange"], st["all_reduce"]
                print(f"  step {i}: wall {1e3 * st['wall']:.1f} ms = exchanges "
                      f"{1e3 * ex['s']:.1f} ms ({ex['calls']} calls, "
                      f"{ex['bytes'] / 1e6:.1f} MB) + all-reduces {1e3 * ar['s']:.1f} ms "
                      f"({ar['calls']} calls, {ar['bytes'] / 1e6:.1f} MB) + the rest "
                      f"{1e3 * (st['wall'] - ex['s'] - ar['s']):.1f} ms (host time inside "
                      f"each call)", flush=True)
            used += [rec["card_in_use_after_steps"], rec["card_in_use_after_backward"]]
            for name, n in rec["launches"].items():
                if n:
                    launches[name] = launches.get(name, 0) + n
        bad = [(r, s) for r, rec in enumerate(recs) for s in rec["log"]
               if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
        if bad or any(len(rec["log"]) != 4 for rec in recs):
            raise SystemExit(f"EP {leg} leg: non-finite losses or grad norms, or missing "
                             f"steps: {bad}")
        strip = lambda log: [{k: v for k, v in s.items() if k not in ("time_s", "tgs")}  # noqa: E731
                             for s in log]
        if any((rec["chunks"], rec["pipeline"], strip(rec["log"]))
               != (first["chunks"], first["pipeline"], strip(first["log"]))
               for rec in recs[1:]):
            raise SystemExit(f"EP {leg} leg: the ranks' schedules or metrics differ")
        for r, rec in enumerate(recs):
            missing = [k for k in EP_KERNELS[leg] if not rec["launches"].get(k)]
            if missing or (leg == "ragged" and rec["launches"].get("fused_moe")):
                raise SystemExit(f"EP {leg} leg, rank {r}: kernels not launched {missing}, "
                                 f"or fused_moe launched on the ragged leg")
            check_peaks({tuple(map(int, k.split(","))): v for k, v in rec["peaks"].items()},
                        who=f"EP {leg} leg, rank {r}: ")
    ce = ranks[0]["fused"]["log"][0]["ce"]
    print(f"step 1 ce: {ce:.6f} on 2 ranks against {one_peer_ce:.6f} at one peer, "
          f"|diff| {abs(ce - one_peer_ce):.3e} (tolerance {TOL_BF16} relative)", flush=True)
    if not abs(ce - one_peer_ce) <= TOL_BF16 * abs(one_peer_ce):
        raise SystemExit("the 2-rank run's step-1 ce differs from the one-peer run's")
    print(f"the card's memory in use at the busiest sample (both ranks, all processes): "
          f"{max(used) / 1e9:.2f} GB", flush=True)
    return launches


# the adaptive + placement phase: the EP phase's model, mesh and batch on the
# fused leg, layer 0's routing skewed toward experts 0 and 1 (which identity
# places together on rank 0), three planner configurations through the entry
# point and the placed one again on the ragged leg through Trainer.  The skew:
# layer 0's router zeroed after init, so every score ties at step 1 and top-2
# (a stable sort, as lax.top_k) sends every token to experts 0 and 1; AdamW
# moves the router from there
ADAPT_STEPS = 3
ADAPT_MIN_IMBALANCE = 1.5
ADAPT_TIMEOUT_S = 900
_STEPS_AT = TRAIN_ARGS.index("--steps") + 1
ADAPT_ARGS = (TRAIN_ARGS[:_STEPS_AT] + [str(ADAPT_STEPS)] + TRAIN_ARGS[_STEPS_AT + 1:]
              + ["--mesh", "x".join(map(str, EP_MESH))])
PLACED = ["--adaptive-mact", "--placement", "--placement-replicas", "1"]
ADAPT_RUNS = (("global MACT", []), ("adaptive", ["--adaptive-mact"]),
              ("adaptive + placement", PLACED),
              ("adaptive + placement, ragged leg", PLACED))
# each kernel's layout key: the weight slots it multiplies (expert kernels)
# or its rows (dispatch kernels), read from its arguments as ops.py calls it
LAYOUT_OF = {"fused_moe": lambda x, w1, *r, **k: ("slots", w1.shape[0]),
             "ragged_matmul": lambda x, w, *r, **k: ("slots", w.shape[0]),
             "ragged_swiglu": lambda x, w1, *r, **k: ("slots", w1.shape[0]),
             "segment_outer": lambda a, b, b2e, rows, bm, out, **k: ("slots", out.shape[0]),
             "scatter_rows": lambda x, src, *r, **k: ("rows", src.shape[0]),
             "gather_combine": lambda buf, *r, **k: ("rows", buf.shape[0])}


def _ragged_rows(slots: int, chunks: int) -> int:
    """R of an EP rank's ragged layout in the adaptive phase: P cap_send
    received rows (cap_send = t_c min(k, slots), t_c one 2048-token
    sequence over the chunks) plus a row block per slot."""
    cap = T_CHUNK // chunks * min(TOP_K, slots)
    return -(-(EP_MESH[1] * cap + slots * BLOCK_M) // BLOCK_M) * BLOCK_M


def _adaptive_rank(rank: int, ports: list, out_dir: str) -> None:
    """One rank of the adaptive + placement phase, started as torchrun
    starts one.  Runs ADAPT_RUNS in turn and writes what it saw to
    out_dir/rank<r>.json.  Each run through the entry point joins a process
    group of its own (the store at ``ports[i]``); the ragged run reuses the
    placed run's mesh."""
    import gc
    import os
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(EP_RANKS),
                      LOCAL_WORLD_SIZE=str(EP_RANKS), MASTER_ADDR="localhost")
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import memory_model as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels._cuda import wrappers
    from repro_torch.launch import train
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    # measurement only: host time and bytes inside each collective (the
    # weight exchange is the one with splits), each step's span and loads,
    # each dispatch plan's rows per peer, and each kernel call's layout
    events, spans, loads, sent, layouts = [], [], [], [], {}

    def timed(kind, real):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            t = args[1] if kind == "exchange" else args[0]
            what = ("weights" if kind == "exchange" and kw.get("input_split_sizes")
                    else kind)
            events.append((t0, time.perf_counter() - t0, what,
                           t.numel() * t.element_size()))
            return out
        return call

    dist.all_to_all_single = timed("exchange", dist.all_to_all_single)
    dist.all_reduce = timed("all_reduce", dist.all_reduce)
    real_plan = dsp.make_unified_plan

    def plan(ids, groups, peers=1, **kw):
        up = real_plan(ids, groups, peers, **kw)
        if peers > 1:                      # rows this rank sends each peer
            sent.append((time.perf_counter(), up.counts.sum(1)))
        return up

    dsp.make_unified_plan = plan

    def recorder(name, real):
        def call(*args, **kw):
            layouts.setdefault(name, set()).add(LAYOUT_OF[name](*args, **kw))
            return real(*args, **kw)
        return call

    for name in LAYOUT_OF:
        setattr(ops, name, recorder(name, getattr(ops, name)))
    real_init, real_step = trainer_mod.init_train_state, trainer_mod.make_train_step

    def skewed_init(*args, **kw):
        state = real_init(*args, **kw)
        with torch.no_grad():
            state.params["layers"][0]["ffn"]["router"]["w"].zero_()
        return state

    def make_step(*args, **kw):
        step = real_step(*args, **kw)

        def run(state, batch):
            t0 = time.perf_counter()
            out = step(state, batch)
            float(out[1]["loss"])              # the trainer's own sync point
            spans.append((t0, time.perf_counter()))
            loads.append(out[1]["load_per_layer"])
            return out
        return run

    trainer_mod.init_train_state = skewed_init
    trainer_mod.make_train_step = make_step
    rec = {"rank": rank}
    try:
        for name, flags in ADAPT_RUNS:
            for fn in wrappers():
                fn.launches = 0
            for lst in (events, spans, loads, sent):
                lst.clear()
            layouts.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if "ragged" not in name:
                if dist.is_initialized():
                    dist.destroy_process_group()
                os.environ["MASTER_PORT"] = str(ports.pop(0))
                trainer, state = train.main(ADAPT_ARGS + flags)
                kw = {k: getattr(trainer, k) for k in (
                    "seq_len", "global_batch", "lr", "seed", "dtype", "max_pipeline_depth",
                    "adaptive_mact", "use_placement", "placement_replicas")}
                cfg, ctx = trainer.cfg, trainer.ctx
            else:
                trainer = Trainer(cfg, dataclasses.replace(ctx, moe_fused=False,
                                                           moe_ragged=True), **kw)
                state = trainer.fit(ADAPT_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in wrappers()}
            vecs = ([[list(s) for s in v] for v in trainer.schedule_trace]
                    or [[[c, d]] * 2 for c, d in zip(trainer.chunk_trace,
                                                      trainer.pipeline_trace)])
            # each step's forward plans come first, layer by layer
            recv = []
            for (a, b), vec in zip(spans, vecs):
                calls = [c.tolist() for t, c in sent if a <= t < b]
                layer, at = [], 0
                for chunks, _ in vec:
                    layer.append(np.sum(calls[at:at + chunks], axis=0).tolist())
                    at += chunks
                recv.append(layer)
            s_pp = trainer.mact.history[-1]["s_pp"]
            s_pp = max(s_pp) if isinstance(s_pp, list) else s_pp
            last = trainer.log[-1]
            report = trainer.mact.memory_report(s_pp, last["chunks"], last["pipeline"])
            replica = mm.replica_weight_bytes(cfg, trainer.mact.replica_slots, trainer.par)
            out = {"log": trainer.log, "schedules": vecs, "wall_s": wall,
                   "placements": [r["placements"] for r in trainer.placement_trace],
                   "replans": [{k: v for k, v in r.items() if k != "placements"}
                               for r in trainer.placement_trace],
                   "launches": launches,
                   "layouts": {k: sorted(v) for k, v in layouts.items()},
                   "sent": recv, "loads": [t.cpu().tolist() for t in loads],
                   "steps": _split_steps(spans, events, ("exchange", "weights",
                                                         "all_reduce")),
                   "max_memory_allocated": trainer.max_memory_allocated,
                   "modeled_bytes": report["total_gb"] * 2**30,
                   "replica_bytes": replica}
            if trainer.use_placement:
                placements = trainer._placements
                peaks, _ = fwd_bwd_peaks(trainer, state, who=f"rank {rank} ({name}, placed): ",
                                         placements=placements)
                ident, _ = fwd_bwd_peaks(trainer, state, who=f"rank {rank} ({name}, identity): ")
                out["peaks"] = {f"{c},{d}": v for (c, d), v in peaks.items()}
                out["peaks_identity"] = {f"{c},{d}": v for (c, d), v in ident.items()}
            rec[name] = out
            del trainer, state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
        if dist.is_initialized():
            dist.destroy_process_group()


def train_adaptive_phase() -> dict:
    """Drive launch/train.py on a 1x2 mesh (2 ranks on the one card over
    gloo) with global MACT, adaptive MACT, and adaptive MACT with expert
    placement, then the placed run on the ragged leg through Trainer;
    returns the path's launch counts, summed over ranks and runs."""
    phase("train (adaptive + placement, 2 ranks)")
    import gc
    import math
    import tempfile

    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ports = set()
        while len(ports) < sum("ragged" not in name for name, _ in ADAPT_RUNS):
            ports.add(_free_port())
        _run_ranks(_adaptive_rank, EP_RANKS, (sorted(ports), tmp), ADAPT_TIMEOUT_S)
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(EP_RANKS)]
    print(f"phase {time.perf_counter() - t0:.1f} s (rank start-up and weights included); "
          f"layer 0's router zeroed after init (step 1 sends every token to experts 0 "
          f"and 1)", flush=True)
    launches = {}
    E_local = E // EP_MESH[1]
    strip = lambda log: [{k: v for k, v in s.items() if k not in ("time_s", "tgs")}  # noqa: E731
                         for s in log]
    for name, _ in ADAPT_RUNS:
        recs = [r[name] for r in ranks]
        first = recs[0]
        leg = "ragged" if "ragged" in name else "fused"
        bad = [(r, s) for r, rec in enumerate(recs) for s in rec["log"]
               if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
        if bad or any(len(rec["log"]) != ADAPT_STEPS for rec in recs):
            raise SystemExit(f"{name}: non-finite losses or grad norms, or missing steps: "
                             f"{bad}")
        if any((rec["schedules"], rec["placements"], strip(rec["log"]))
               != (first["schedules"], first["placements"], strip(first["log"]))
               for rec in recs[1:]):
            raise SystemExit(f"{name}: the ranks' schedules, placements or metrics differ")
        # received token-slots: what both ranks sent each rank, per layer
        recv = [[[sum(rec["sent"][i][layer][p] for rec in recs)
                  for p in range(EP_MESH[1])] for layer in range(2)]
                for i in range(ADAPT_STEPS)]
        for i, step in enumerate(first["log"]):
            lpl = np.asarray(first["loads"][i], dtype=np.float64)
            imb = lpl.max(1) / lpl.mean(1)
            ex, wx, ar = (first["steps"][i][k] for k in ("exchange", "weights", "all_reduce"))
            print(f"{name}, step {step['step']}: loss {step['loss']:.6f} (ce "
                  f"{step['ce']:.6f}), grad_norm {step['grad_norm']:.4f}, schedules "
                  f"{[tuple(v) for v in first['schedules'][i]]}, {step['time_s']:.3f} s; "
                  + "; ".join(f"layer {j}: imbalance {imb[j]:.3f}, received token-slots "
                              f"{recv[i][j]} (hottest rank {max(recv[i][j]):.0f})"
                              for j in range(2))
                  + f"; weight exchange {wx['calls']} calls, {wx['bytes'] / 1e6:.1f} MB, "
                  f"{1e3 * wx['s']:.1f} ms; row exchanges {1e3 * ex['s']:.1f} ms; "
                  f"all-reduces {1e3 * ar['s']:.1f} ms; the rest "
                  f"{1e3 * (step['time_s'] - ex['s'] - wx['s'] - ar['s']):.1f} ms (rank 0)",
                  flush=True)
        warm = [s["time_s"] for s in first["log"][1:]]
        print(f"{name}: schedule vectors {[[tuple(v) for v in vec] for vec in first['schedules']]}; "
              f"warm steps {min(warm):.3f}-{max(warm):.3f} s ({EP_LABEL})", flush=True)
        for r, rec in enumerate(recs):
            print(f"{name}, rank {r}: max_memory_allocated "
                  f"{rec['max_memory_allocated'] / 1e9:.2f} GB against MACT's per-rank "
                  f"model {rec['modeled_bytes'] / 1e9:.2f} GB + replica slots "
                  f"{rec['replica_bytes'] / 1e9:.2f} GB = "
                  f"{(rec['modeled_bytes'] + rec['replica_bytes']) / 1e9:.2f} GB; launches "
                  f"{ {k: n for k, n in rec['launches'].items() if n} }", flush=True)
            for name_k, n in rec["launches"].items():
                if n:
                    launches[name_k] = launches.get(name_k, 0) + n
        if "placement" not in name:
            continue
        for rep in first["replans"]:
            print(f"{name}: replan before step {rep['step'] + 1}: migrated_slots "
                  f"{rep['migrated_slots']}, {rep['migrated_bytes'] / 1e6:.1f} MB a step "
                  f"through the weight exchange, identity {rep['identity']}, imbalance "
                  f"{rep['imbalance']}", flush=True)
        print(f"{name}: placements {first['placements'][-1]}", flush=True)
        for r, rec in enumerate(recs):
            gap = {k: rec["peaks"][k] - rec["peaks_identity"][k] for k in rec["peaks"]}
            print(f"{name}, rank {r}: forward + backward peak with the placement above the "
                  f"same schedule at identity (slot copies, their gradients and the "
                  f"exchange's buffers, which MACT does not price): "
                  + ", ".join(f"({k}) {v / 1e9:+.3f} GB" for k, v in gap.items()), flush=True)
            check_peaks({tuple(map(int, k.split(","))): v for k, v in rec["peaks"].items()},
                        who=f"{name}, rank {r}: ")
        places = first["placements"]
        if len(places) < 2 or places[1][0] == list(range(E)):
            raise SystemExit(f"{name}: layer 0's placement is still identity after the "
                             f"first replan: {places}")
        if any(p[1] != list(range(E)) for p in places):
            raise SystemExit(f"{name}: layer 1's placement moved: {places}")
        slots = len(places[-1][0]) // EP_MESH[1]
        r5 = {_ragged_rows(slots, c) for c in (1, 2, 4, 8)}
        for r, rec in enumerate(recs):
            missing = [k for k in EP_KERNELS[leg]
                       if not any((kind == "slots" and v == slots)
                                  or (kind == "rows" and v in r5)
                                  for kind, v in rec["layouts"].get(k, []))]
            if missing:
                raise SystemExit(f"{name}, rank {r}: kernels not launched at the "
                                 f"{slots}-slot layout: {missing} (layouts seen "
                                 f"{rec['layouts']})")
        before, after = max(recv[0][0]), max(recv[-1][0])
        print(f"{name}: layer 0's hottest rank received {before:.0f} token-slots at "
              f"step 1 (identity) and {after:.0f} at step {ADAPT_STEPS} (placed, "
              f"{slots} slots a rank, E_local {E_local} before)", flush=True)
        if not after < before:
            raise SystemExit(f"{name}: layer 0's hottest rank received no fewer "
                             f"token-slots after the replan")
    glob, placed = (ranks[0][n]["log"][0] for n in ("global MACT", "adaptive + placement"))
    imb0 = np.asarray(ranks[0]["global MACT"]["loads"][0], dtype=np.float64)
    imb0 = float(imb0[0].max() / imb0[0].mean())
    keys = ("loss", "ce", "aux", "grad_norm", "max_load", "drops", "chunks", "pipeline")
    same = [glob[k] for k in keys] == [placed[k] for k in keys]
    print(f"step 1: layer 0's imbalance {imb0:.3f} (at least {ADAPT_MIN_IMBALANCE}); the "
          f"placed run's step 1 (identity at cold start) "
          f"{'equals' if same else 'DIFFERS from'} the global run's bit for bit "
          f"(loss {placed['loss']!r} / {glob['loss']!r}, grad_norm "
          f"{placed['grad_norm']!r} / {glob['grad_norm']!r})", flush=True)
    if imb0 < ADAPT_MIN_IMBALANCE:
        raise SystemExit(f"layer 0's step-1 imbalance {imb0:.3f} is below "
                         f"{ADAPT_MIN_IMBALANCE}: the skew did not take")
    if not same:
        raise SystemExit("the placed run's first step differs from the global run's")
    return launches


# the resilience phase: full-width Mixtral-8x7B at 1 layer (depth cut from
# 32: 1.713 B params, 20.6 GB of weights and moments, 17.1 GB a checkpoint),
# bf16, EP at one peer, the fused leg
RES_ARGS = ["--arch", "mixtral-8x7b", "--layers", "1", "--ep", "--fused",
            "--steps", "4", "--seq-len", "2048", "--global-batch", "2",
            "--lr", "1e-4", "--seed", "0"]
# (a) MACT at depth 1 plans (1, 1) at this size (s'' 8192 against s'max
# 377543), so the injected OOM's first rung, (2, 1), is a deeper chunk count,
# and a burst of 64x the observed load (more than s'max / s'') raises the
# next plan to 2 chunks
RES_BURST = 64.0
RES_INJECT = f"oom@2,burst@2x{RES_BURST:g}"
# (b) a real OOM: 32 sequences of 512 tokens, where the MoE layer's backward
# sets the step's peak (at 4 x 4096, attention's scores set it and (1, 1) is
# only ~0.23 GB above (2, 1)); the rungs' peaks must differ by this much
OOM_SEQ, OOM_BATCH, OOM_GAP = 512, 32, 0.5e9
RES_TIMEOUT_S = 600


def state_digest(state) -> str:
    """A digest of every parameter's and moment's bits, computed on the card
    (two 64-bit sums of each tensor's words, one position-weighted)."""
    import hashlib

    import torch
    from repro_torch.optim.adamw import param_list
    sums = []
    for t in param_list(state.params) + list(state.opt.mu) + list(state.opt.nu):
        w = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
        s1 = s2 = 0
        for i in range(0, w.numel(), 1 << 26):
            c = w[i:i + (1 << 26)].to(torch.int64)
            s1 += int(c.sum())
            s2 += int((c * (torch.arange(c.numel(), device=c.device) % 65521 + 1)).sum())
        sums.append((s1, s2))
    return hashlib.sha256(repr((state.step, state.opt.step, sums)).encode()).hexdigest()[:16]


def _res_cfg():
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mixtral-8x7b"), num_layers=1)


def _fused_ctx(**kw):
    import torch
    from repro_torch.core.moe import DistContext
    return DistContext(device=torch.device("cuda"), moe_strategy="ep_shardmap",
                       moe_fused=True, **kw)


def _injected_ladder() -> None:
    """(a) launch/train.py --inject: one escalation at step 2 to a deeper
    chunk count, and a burst that raises MACT's next chunk count."""
    import math

    from repro_torch.launch import train
    trainer, state = train.main(RES_ARGS + ["--no-pipeline", "--inject", RES_INJECT])
    esc, audits = trainer.guard.escalations, trainer.guard.audits
    print(f"(a) --inject {RES_INJECT} --no-pipeline: chunk trace {trainer.chunk_trace}, "
          f"pipeline trace {trainer.pipeline_trace}, oom_retries "
          f"{[r['oom_retries'] for r in trainer.log]}, losses "
          f"{[round(r['loss'], 6) for r in trainer.log]}, fired {trainer.injector.fired}",
          flush=True)
    for a in audits:
        print(f"    audit: step {a['step']} {a['key']}: MACT's model "
              f"{a['modeled_total_gb']:.3f} GiB (fits: {a['modeled_fits']}), headroom "
              f"{a.get('headroom')}", flush=True)
    plan = trainer.mact.history[-1]
    unburst = trainer.mact._schedule_for(plan["s_pp"] / RES_BURST, 1).chunks
    print(f"    MACT after the burst: s'' {plan['s_pp']:.0f} -> (chunks {plan['bin']}, depth "
          f"{plan['depth']}); the same load without the burst: chunks {unburst}", flush=True)
    ok = (len(esc) == 1 and esc[0]["step"] == 2
          and [r["oom_retries"] for r in trainer.log] == [0, 0, 1, 0]
          and trainer.log[2]["chunks"] > trainer.log[1]["chunks"]
          and trainer.log[3]["chunks"] > unburst
          and all(math.isfinite(r["loss"]) for r in trainer.log))
    if not ok:
        raise SystemExit("(a) the injected ladder did not escalate once at step 2 to a "
                         "deeper chunk count, or the burst did not raise the next plan")
    del trainer, state


def _real_oom_child(rank: int, out_dir: str) -> None:
    """(b), in a process of its own, whose allocator maps expandable
    segments (PYTORCH_CUDA_ALLOC_CONF, set by the parent): one step of the
    incumbent (1, 1) and of the rungs (2, 1), (4, 1) uncapped from the same
    seed, then the incumbent under a memory cap between the peaks of (1, 1)
    and (2, 1), through the guard."""
    import gc

    import torch
    from repro_torch.kernels._cuda import wrappers
    from repro_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    for fn in wrappers():
        fn.launches = 0
    cfg, total = _res_cfg(), torch.cuda.get_device_properties(0).total_memory
    out = {"runs": {}}

    def run(c: int, cap=None) -> dict:
        gc.collect()
        torch.cuda.empty_cache()
        if cap:
            torch.cuda.set_per_process_memory_fraction(cap / total)
        tr = Trainer(cfg, _fused_ctx(moe_chunks=c, pipeline_chunks=1), seq_len=OOM_SEQ,
                     global_batch=OOM_BATCH, lr=1e-4, seed=0, dtype=torch.bfloat16,
                     use_mact=False)
        spans, real = [], tr._step_for

        def timed(key):                       # each attempt's seconds
            fn = real(key)

            def attempt(state, batch):
                t0 = time.perf_counter()
                try:
                    res = fn(state, batch)
                    float(res[1]["loss"])
                    spans.append([str(key), time.perf_counter() - t0, "ok"])
                    return res
                except torch.cuda.OutOfMemoryError:
                    spans.append([str(key), time.perf_counter() - t0, "OutOfMemoryError"])
                    raise
            return attempt

        tr._step_for = timed
        try:
            state = tr.fit(1)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        rec = {"loss": tr.log[0]["loss"], "chunks": tr.log[0]["chunks"],
               "pipeline": tr.log[0]["pipeline"], "step_s": tr.log[0]["time_s"],
               "allocated": torch.cuda.max_memory_allocated(),
               "reserved": torch.cuda.max_memory_reserved(), "digest": state_digest(state),
               "spans": spans, "escalations": tr.guard.escalations,
               "audits": tr.guard.audits}
        del state, tr
        return rec

    for c in (1, 2, 4):
        out["runs"][c] = run(c)
    a1, a2 = out["runs"][1]["allocated"], out["runs"][2]["allocated"]
    out["cap"] = (a1 + a2) / 2
    out["total"] = total
    if a1 - a2 >= OOM_GAP:
        out["capped"] = run(1, out["cap"])
    out["launches"] = {fn.__name__: fn.launches for fn in wrappers()}
    Path(out_dir, "oom.json").write_text(json.dumps(out, default=str))


def _real_oom(launches: dict) -> None:
    """(b) a real torch.cuda.OutOfMemoryError caught by the guard, and the
    step finished on a rung bit-equal to the uncapped run on that rung."""
    import tempfile
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _run_ranks(_real_oom_child, 1, (tmp,), RES_TIMEOUT_S)
            out = json.loads(Path(tmp, "oom.json").read_text())
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    for name, n in out["launches"].items():
        launches[name] = launches.get(name, 0) + n
    runs = out["runs"]
    for c, r in runs.items():
        print(f"(b) uncapped ({c}, 1), {OOM_BATCH} x {OOM_SEQ} tokens: loss {r['loss']!r}, "
              f"max_memory_allocated {r['allocated'] / 1e9:.3f} GB, max_memory_reserved "
              f"{r['reserved'] / 1e9:.3f} GB, step {r['step_s']:.3f} s, digest {r['digest']}",
              flush=True)
    gap = runs["1"]["allocated"] - runs["2"]["allocated"]
    print(f"    (1, 1) above (2, 1): {gap / 1e9:.3f} GB allocated, "
          f"{(runs['1']['reserved'] - runs['2']['reserved']) / 1e9:.3f} GB reserved; cap "
          f"{out['cap'] / 1e9:.3f} GB (set_per_process_memory_fraction "
          f"{out['cap'] / out['total']:.5f})", flush=True)
    if gap < OOM_GAP or "capped" not in out:
        raise SystemExit(f"(b) (1, 1)'s peak is only {gap / 1e9:.3f} GB above (2, 1)'s: "
                         f"no cap between them can be trusted")
    cap = out["capped"]
    for e in cap["escalations"]:
        print(f"    escalation: step {e['step']} {e['failed']} -> {e['next']}: "
              f"{e['error'][:150]}", flush=True)
    for a in cap["audits"]:
        print(f"    audit: MACT's model {a['modeled_total_gb']:.3f} GiB (fits: "
              f"{a['modeled_fits']}); the failed attempt: peak allocated "
              f"{a['peak_allocated_gb']:.3f} GiB, reserved {a['peak_reserved_gb']:.3f} GiB, "
              f"refused {a['tried_gb']} GiB", flush=True)
    for key, s, how in cap["spans"]:
        print(f"    attempt {key}: {s:.3f} s, {how}", flush=True)
    retry_s = cap["step_s"] - sum(s for _, s, _ in cap["spans"])
    print(f"    the step under the cap: {cap['step_s']:.3f} s (release between attempts "
          f"{retry_s:.3f} s), loss {cap['loss']!r}, digest {cap['digest']}, rung "
          f"({cap['chunks']}, {cap['pipeline']})", flush=True)
    rung = runs.get(str(cap["chunks"]))
    real = [e for e in cap["escalations"] if "CUDA out of memory" in e["error"]]
    if (not real or rung is None or cap["loss"] != rung["loss"]
            or cap["digest"] != rung["digest"]):
        raise SystemExit("(b) no real CUDA OOM was caught, or the step did not finish on a "
                         "rung bit-equal to the uncapped run on that rung")


def _kill_and_resume() -> None:
    """(c) run A 4 steps; run B checkpoints every 2 and crashes at step 3;
    run C resumes to step 4: steps 3-4 and the final state equal A's bit for
    bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.runtime.faults import FaultInjector, SimulatedCrash
    from repro_torch.training.trainer import Trainer

    cfg = _res_cfg()
    kw = dict(seq_len=2048, global_batch=2, lr=1e-4, seed=0, dtype=torch.bfloat16)
    a = Trainer(cfg, _fused_ctx(), **kw)
    state = a.fit(4)
    want = state_digest(state)
    params = sum(p.numel() for p in state.opt.mu)
    del state
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="resilience-ckpt-")
    try:
        free = shutil.disk_usage(ckpt).free
        need = params * 10
        print(f"(c) {params / 1e9:.3f} B params: a checkpoint of ~{need / 1e9:.2f} GB "
              f"(10 B/param) into {ckpt}, {free / 1e9:.1f} GB free", flush=True)
        if free < need * 1.1:
            raise SystemExit(f"(c) the disk has {free / 1e9:.1f} GB free, the checkpoint "
                             f"needs {need / 1e9:.1f}")
        b = Trainer(cfg, _fused_ctx(), checkpoint_dir=ckpt, checkpoint_every=2,
                    injector=FaultInjector.from_string("crash@3"), **kw)
        try:
            b.fit(4)
            raise SystemExit("(c) run B did not crash at step 3")
        except SimulatedCrash as e:
            print(f"    run B: {e} after steps {[r['step'] for r in b.log]}", flush=True)
        for rec in b.checkpoint_log:
            print(f"    run B's checkpoint at step {rec['step']}: {rec['bytes']} bytes "
                  f"({rec['bytes'] / 1e9:.3f} GB), save {rec['save_s']:.2f} s", flush=True)
        del b
        torch.cuda.empty_cache()
        c = Trainer(cfg, _fused_ctx(), checkpoint_dir=ckpt, resume=True, **kw)
        state = c.fit(4)
        got = state_digest(state)
        for rec in c.checkpoint_log:
            print(f"    run C resumed from step {rec['resumed_from']}: verify (sha256 of "
                  f"the payload) {rec['verify_s']:.2f} s, restore {rec['restore_s']:.2f} s",
                  flush=True)
        print(f"    losses A {[r['loss'] for r in a.log]}; C {[r['loss'] for r in c.log]}; "
              f"digests A {want} C {got}", flush=True)
        ok = (c.resumed_from == 2 and [r["step"] for r in c.log] == [3, 4]
              and [r["loss"] for r in c.log] == [r["loss"] for r in a.log[2:]]
              and got == want)
        del state, c
        if not ok:
            raise SystemExit("(c) the resumed run is not bit-identical to run A")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _resume_rank(rank: int, store: str, out_dir: str, device: str = "cuda") -> None:
    """(d) one of 2 card ranks (gloo) on a 1x2 mesh, the reduced config in
    fp32: the kill-and-resume of (c) with an injected OOM walked in
    lockstep at step 1, then one rank's torn payload."""
    import torch
    import torch.distributed as dist
    from repro_torch import checkpointing
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.kernels._cuda import wrappers
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime.faults import FaultInjector, SimulatedCrash
    from repro_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    for fn in wrappers():
        fn.launches = 0
    try:
        dev = mesh_lib.init_world(rank, 2, store, device)
        mesh = mesh_lib.make_host_mesh((1, 2))
        cfg = get_config("mixtral-8x7b").reduced()
        ctx = DistContext(device=dev, moe_strategy="ep_shardmap", moe_fused=True, mesh=mesh)
        kw = dict(seq_len=128, global_batch=2, lr=1e-3)
        a_dir, b_dir = str(Path(out_dir, "a")), str(Path(out_dir, "b"))
        a = Trainer(cfg, ctx, checkpoint_dir=a_dir, checkpoint_every=2,
                    injector=FaultInjector.from_string("oom@1"), **kw)
        want = state_digest(a.fit(4))
        b = Trainer(cfg, ctx, checkpoint_dir=b_dir, checkpoint_every=2,
                    injector=FaultInjector.from_string("oom@1,crash@3"), **kw)
        try:
            b.fit(4)
            crashed = False
        except SimulatedCrash:
            crashed = True
        c = Trainer(cfg, ctx, checkpoint_dir=b_dir, resume=True, **kw)
        got = state_digest(c.fit(4))
        rec = {"crashed": crashed, "resumed_from": c.resumed_from, "want": want, "got": got,
               "losses_a": [r["loss"] for r in a.log], "losses_c": [r["loss"] for r in c.log],
               "retries_a": [r["oom_retries"] for r in a.log],
               "files": sorted(os.listdir(b_dir))}
        mesh.barrier()
        if rank == 1:                          # tear this rank's newest payload only
            path = checkpointing.payload(a_dir, 4, rank, 2)
            os.truncate(path, os.path.getsize(path) // 2)
        mesh.barrier()
        rec["valid_a"] = checkpointing.valid_steps(a_dir, world=2)
        rec["launches"] = {fn.__name__: fn.launches for fn in wrappers()}
        Path(out_dir, f"resume{rank}.json").write_text(json.dumps(rec))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh_kill_and_resume(launches: dict) -> None:
    """(d) the same kill-and-resume on 2 card ranks: per-rank files, a torn
    file of one rank invalidating the step for both."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        _run_ranks(_resume_rank, 2, (f"file://{tmp}/store", tmp), 300)
        recs = [json.loads(Path(tmp, f"resume{r}.json").read_text()) for r in range(2)]
    for r, rec in enumerate(recs):
        print(f"(d) rank {r}: run A losses {rec['losses_a']} (oom_retries "
              f"{rec['retries_a']}); run B crashed: {rec['crashed']}; run C resumed from "
              f"{rec['resumed_from']}, losses {rec['losses_c']}; digests A {rec['want']} C "
              f"{rec['got']}; files {rec['files']}; valid steps after rank 1's step-4 "
              f"payload was torn: {rec['valid_a']}", flush=True)
        for name, n in rec["launches"].items():
            if n:
                launches[name] = launches.get(name, 0) + n
    ok = all(rec["crashed"] and rec["resumed_from"] == 2 and rec["got"] == rec["want"]
             and rec["losses_c"] == rec["losses_a"][2:] and rec["retries_a"] == [0, 1, 0, 0]
             and rec["valid_a"] == [2] for rec in recs)
    if not ok or recs[0]["losses_a"] != recs[1]["losses_a"]:
        raise SystemExit("(d) the 2-rank kill-and-resume is not bit-identical, the ranks "
                         "disagree, or one rank's torn file did not invalidate the step")


def train_resilience_phase() -> dict:
    """Drive the trainer's resilience path at full width, 1 layer: (a) the
    injected ladder through launch/train.py, (b) a real CUDA OOM recovered,
    (c) kill and resume, (d) the same on 2 card ranks at the reduced size.
    Returns the path's launch counts, the children's included."""
    phase("train (resilience)")
    import gc

    import torch
    from repro_torch.kernels._cuda import wrappers

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    for fn in wrappers():
        fn.launches = 0
    t0 = time.perf_counter()
    children: dict = {}
    _injected_ladder()
    _real_oom(children)
    _kill_and_resume()
    launches = {fn.__name__: fn.launches for fn in wrappers() if fn.launches}
    _mesh_kill_and_resume(children)
    for name, n in children.items():
        launches[name] = launches.get(name, 0) + n
    print(f"phase {time.perf_counter() - t0:.1f} s; launches {launches}", flush=True)
    missing = [k for k in EP_KERNELS["fused"] if not launches.get(k)]
    if missing:
        raise SystemExit(f"the resilience path never launched {missing}")
    return launches


def serve_phase():
    """Drive the port's serving entry point (compiled steps: CUDA graphs);
    returns the kernels' launch counts from this run and what the profile
    phase reuses: the weights, the config and what the run served."""
    phase("serve")
    import torch
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.launch import serve
    from repro_torch.models.transformer import num_moe_layers
    from repro_torch.serving import engine

    torch.cuda.reset_peak_memory_stats()
    counters = (gm.grouped_swiglu, gm.grouped_matmul)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    sched, m = serve.main(SERVE_ARGS)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    wall = time.perf_counter() - t0

    n_moe = num_moe_layers(sched.cfg)
    forwards = m["decode_waves"] + m["prefill_chunks"]
    info = engine.step_cache_info()
    print(f"serve phase {wall:.1f} s (weights built on the card included); "
          f"{m['tok_per_s']:.1f} tok/s, p50 {m['latency_p50_s']:.3f} s, "
          f"p99 {m['latency_p99_s']:.3f} s, {m['decode_waves']} decode waves, "
          f"{m['prefill_chunks']} prefill chunks, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {info['captures']} "
          f"graphs captured in {info['capture_s']:.3f} s", flush=True)
    print(f"launches {launches}: {n_moe} MoE layers x {forwards} forward passes "
          f"-> {n_moe} of each kernel per decode wave", flush=True)
    unfinished = [r.rid for r in sched.finished if len(r.out) != r.max_new_tokens]
    if m["requests"] != 8 or unfinished or sched.queue or sched.active:
        raise SystemExit(f"not every request finished: {m['requests']}/8 done, "
                         f"short {unfinished}")
    if m["nonfinite_logits"]:
        raise SystemExit(f"{m['nonfinite_logits']} sampled logit rows were not finite")
    if sched.eager or not info["graphs"]:
        raise SystemExit("the serve path ran no CUDA graph")
    for name, n in launches.items():
        if n != n_moe * forwards:
            raise SystemExit(f"{name} launched {n} times; the path runs it "
                             f"{n_moe * forwards} times (once per MoE layer per pass)")
    served = {"params": sched.params, "cfg": sched.cfg, "ctx": sched.ctx,
              "scfg": sched.scfg,
              "streams": [r.out for r in sorted(sched.finished, key=lambda r: r.rid)],
              "order": list(sched.admission_order),
              "waves": m["decode_waves"], "chunks": m["prefill_chunks"]}
    reset_check(sched, served)
    return launches, served


def reset_check(sched, served: dict) -> None:
    """The serve phase's scheduler reset and run again on the same trace:
    the streams, admission order and counts must equal the first run's, and
    no graph may be captured (reset keeps the compiled steps, their graphs,
    the static caches and the slot pool)."""
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    before = engine.step_cache_info()
    sched.reset()
    m = sched.run(serve.request_trace(serve.parse_args(SERVE_ARGS), sched.cfg))
    after = engine.step_cache_info()
    got = ([r.out for r in sorted(sched.finished, key=lambda r: r.rid)],
           list(sched.admission_order), m["decode_waves"], m["prefill_chunks"])
    same = got == (served["streams"], served["order"], served["waves"], served["chunks"])
    captured = after["captures"] - before["captures"]
    print(f"serve after reset(): {m['requests']} requests, {m['decode_waves']} decode "
          f"waves, {m['prefill_chunks']} prefill chunks, {m['tok_per_s']:.1f} tok/s; "
          f"streams, order and counts {'equal' if same else 'DIFFER from'} the first "
          f"run's; {captured} graphs captured", flush=True)
    if not same or captured:
        raise SystemExit("the serve trace after reset() differs from the first run, or "
                         "captured a graph")


def _serve_run(args, params, profiler=None) -> dict:
    """One run of the serve trace on ``params`` by a new scheduler (eager
    or compiled per ``args.eager``); the scheduler is dropped at the end, so
    a later compiled run takes over its static caches and warm graphs."""
    import gc

    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    sched, trace = serve.setup(args, params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = engine.step_cache_info()
    if profiler is None:
        m = sched.run(trace)
    else:
        with profiler:
            m = sched.run(trace)
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    after = engine.step_cache_info()
    passes = m["decode_waves"] + m["prefill_chunks"]
    run = {"eager": args.eager, "metrics": m, "passes": passes,
           "ms_per_pass": 1e3 * m["elapsed_s"] / passes,
           "streams": [r.out for r in sorted(sched.finished, key=lambda r: r.rid)],
           "order": list(sched.admission_order),
           "captures": after["captures"] - before["captures"],
           "capture_s": after["capture_s"] - before["capture_s"],
           "peak": torch.cuda.max_memory_allocated(),
           "pool_bytes": after["pool_bytes"], "static_bytes": after["static_bytes"]}
    del sched
    gc.collect()
    return run


def _fmt_bytes(n) -> str:
    return "not measured" if n is None else f"{n / 1e6:.1f} MB"


class _Holder:
    """Holds a compiled step's static cache for a timing."""


def profile_phase(served: dict) -> None:
    """The serve trace again on the serve phase's weights, compiled (its
    graphs warm) and eager in turns, each run by a new scheduler; then one
    run of each under torch.profiler, and a decode wave's device time both
    ways.  Streams, admission order and counts must equal the serve
    phase's."""
    phase("profile")
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    params, cfg, ctx, scfg = (served[k] for k in ("params", "cfg", "ctx", "scfg"))
    want = (served["streams"], served["order"], served["waves"], served["chunks"])
    gc.collect()                    # the serve phase's scheduler frees its static caches
    modes = {False: serve.parse_args(SERVE_ARGS),
             True: serve.parse_args(SERVE_ARGS + ["--eager"])}
    runs = [_serve_run(modes[eager], params)
            for eager in (True, False, True, False, True, False)]
    for r in runs:
        m = r["metrics"]
        got = (r["streams"], r["order"], m["decode_waves"], m["prefill_chunks"])
        if got != want:
            raise SystemExit(f"the {'eager' if r['eager'] else 'compiled'} serve run "
                             f"differs from the serve phase's (streams, order, counts)")
    print(f"serve trace, {runs[0]['passes']} forward passes a run: streams, "
          f"admission order, decode waves and prefill chunks identical over "
          f"{len(runs)} runs (eager and compiled) and the serve phase", flush=True)

    # the profiled runs: device busy time, by kernel
    busy = {}
    for eager in (False, True):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        r = _serve_run(modes[eager], params, profiler=prof)
        rows = device_kernels(prof)
        device_us = sum(x[2] for x in rows)
        by_kernel = {g: sum(x[2] for x in rows if any(k in x[0] for k in keys))
                     for g, keys in SERVE_GROUPS.items()}
        busy[eager] = device_us / 1e3
        name = "eager" if eager else "compiled"
        print(f"profiled {name} run: wall {1e3 * r['metrics']['elapsed_s']:.1f} ms, "
              f"device busy {device_us / 1e3:.1f} ms, "
              f"{device_us / 1e3 / r['passes']:.2f} ms a forward pass; by kernel: "
              + ", ".join(f"{g} {us / 1e3:.1f} ms ({100 * us / max(device_us, 1):.1f}%)"
                          for g, us in by_kernel.items())
              + f", everything else {(device_us - sum(by_kernel.values())) / 1e3:.1f} ms",
              flush=True)
        for key, count, us in sorted(rows, key=lambda x: -x[2])[:8]:
            print(f"  {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
        if not eager and not all(by_kernel.values()):
            print("torch.profiler does not see the grouped kernels inside graph "
                  "replays: read the decode wave's device time below (CUDA events)",
                  flush=True)

    for r in runs:
        m = r["metrics"]
        name = "eager" if r["eager"] else "compiled"
        print(f"warm {name} run: {r['ms_per_pass']:.2f} ms a forward pass, "
              f"{m['tok_per_s']:.1f} tok/s, p50 {m['latency_p50_s']:.3f} s, "
              f"p99 {m['latency_p99_s']:.3f} s, device idle "
              f"{100 - 100 * busy[r['eager']] / (1e3 * m['elapsed_s']):.1f}% of the "
              f"wall; {r['captures']} graphs captured ({r['capture_s']:.3f} s); "
              f"max_memory_allocated {r['peak'] / 1e9:.3f} GB against the modeled "
              f"peak {m['modeled_peak_bytes'] / 1e9:.3f} GB; graphs' pool "
              f"{_fmt_bytes(r['pool_bytes'])}, static buffers "
              f"{_fmt_bytes(r['static_bytes'])}", flush=True)
    if any(r["captures"] for r in runs if not r["eager"]):
        raise SystemExit("a warm compiled run captured a graph: its steps were not warm")

    # one decode wave both ways: logits bit for bit, device time by CUDA events
    step = engine.get_decode_step(cfg, ctx)
    a, b = (engine.init_serve_cache(params, cfg, scfg.max_slots, scfg.cache_len)
            for _ in range(2))
    gen = torch.Generator(device="cpu").manual_seed(0)
    diff = 0.0
    for _ in range(3):
        tok = torch.randint(0, cfg.vocab_size, (scfg.max_slots, 1), generator=gen).cuda()
        got, a = step(params, a, tok)
        want_l, b = step.eager(params, b, tok)
        diff = max(diff, (got - want_l).abs().max().item())
    holder = _Holder()
    own = step.static_cache(a, holder)          # a wave that copies no cache
    replay_ms, replay_host, _ = device_ms(lambda: step(params, own, tok))
    # one eager call a timing: its host time must fit under the spin kernel
    eager_ms, eager_host, note = device_ms(lambda: step.eager(params, b, tok), iters=1)
    print(f"decode wave (4 slots) compiled against eager: logits max |diff| = "
          f"{diff:.3e}; device {replay_ms:.4f} / {eager_ms:.4f} ms{note}, host "
          f"{replay_host:.4f} / {eager_host:.4f} ms a wave", flush=True)
    if diff != 0.0 or not np.isfinite(diff):
        raise SystemExit("the decode graph's logits differ from the eager step's")
    del a, b, own, holder, step
    engine.clear_step_cache()
    torch.cuda.empty_cache()


# the paged phase: (a) the serve trace at 16-token pages; (b) and (c) a
# shared 32-token system prompt and a 16-32-token tail per request, 8-24
# tokens generated, at Mixtral's whole 4096-token window (a slot-map slot
# would reserve a 4096-token ring)
PAGE = 16
PREFIX_SLOTS, PREFIX_CACHE_LEN, PREFIX_STEM = 4, 4096, 32
PREFIX_TAIL, PREFIX_GEN = (16, 32), (8, 24)
PREFIX_HITS = 4              # of the 8 requests
BUDGET_REQUESTS = 2.2        # (c): room for about two requests' worst case


def _recording(sched, store: dict) -> None:
    """Keep a copy of every logits row ``sched`` samples a token from, by
    (request, token index)."""
    append = sched._append_token

    def rec(req, logits_v, now):
        store[(req.rid, len(req.out))] = logits_v.copy()
        return append(req, logits_v, now)

    sched._append_token = rec


def _timed(fn, seconds: list):
    """``fn`` timed by the host clock between two synchronizes."""
    import torch

    def call(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def _prefix_trace(cfg, priorities=False):
    """(b)'s 8 requests; with ``priorities`` the last 6 may preempt the
    first 2."""
    import numpy as np
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(11)
    stem = rng.integers(0, cfg.vocab_size, PREFIX_STEM)
    out = []
    for i in range(8):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(PREFIX_TAIL[0],
                                                                PREFIX_TAIL[1] + 1)))
        out.append(Request(rid=i, tokens=np.concatenate([stem, tail]).astype(np.int32),
                           max_new_tokens=int(rng.integers(PREFIX_GEN[0],
                                                           PREFIX_GEN[1] + 1)),
                           priority=int(priorities and i >= 2)))
    return out


def _paged_run(argv, params, trace=None, record=None, spill=None, restore=None,
               preempt_steps=None) -> dict:
    """One run of the launcher's scheduler (``serve.setup``) on ``params``:
    ``trace`` replaces the launcher's own; the scheduler is dropped at the
    end.  Returns the metrics, streams, order and what the wave and spill
    timings need."""
    import gc

    import torch
    from repro_torch.launch import serve
    from repro_torch.serving import engine as serve_engine

    sched, own = serve.setup(serve.parse_args(argv), params=params)
    if record is not None:
        _recording(sched, record)
    if spill is not None:
        sched.pool.spill = _timed(sched.pool.spill, spill)
        sched.pool.restore = _timed(sched.pool.restore, restore)
    if preempt_steps is not None:
        preempt = sched._preempt

        def rec(victim):
            preempt_steps.append(sched.steps)
            return preempt(victim)
        sched._preempt = rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = sched.run(own if trace is None else trace)
    torch.cuda.synchronize()
    run = {"metrics": m, "peak": torch.cuda.max_memory_allocated(),
           "streams": [r.out for r in sorted(sched.finished, key=lambda r: r.rid)],
           "order": list(sched.admission_order), "scfg": sched.scfg,
           "passes": m["decode_waves"] + m["prefill_chunks"]}
    unfinished = [r.rid for r in sched.finished if len(r.out) != r.max_new_tokens]
    if sched.queue or sched.active or unfinished or m["nonfinite_logits"]:
        raise SystemExit(f"{' '.join(argv[-6:])}: not every request finished with "
                         f"finite logits (short {unfinished})")
    # what the cache holds on the card: the page pools, or the slot map's cache
    run["cache_bytes"] = sum(t.nbytes for t in serve_engine.leaves(
        sched.pool.pools if hasattr(sched, "pool") else sched.cache))
    if hasattr(sched, "pool"):
        pools = sched.pool.pools          # a mamba layer's: {"ssm", "conv"}
        run["state_pool_bytes"] = sum(t.nbytes for p in pools if "ssm" in p
                                      for t in p.values())
        run["state_block_bytes"] = sched.pool.layout.state_bytes(sched.scfg.dtype_bytes)
        sched.pool.alloc.audit()
        if sched.trie is not None:
            sched.trie.clear()
        leaked = [k for k in sched.pool.alloc.spaces if sched.pool.alloc.allocated(k)]
        if leaked:
            raise SystemExit(f"the paged run leaked pages of {leaked}")
        step = sched.pool._decode
        run.update(captures=step.captures, capture_s=step.capture_s,
                   graphs=step.graphs(),
                   worst_case=max(sched.pool.ops.worst_case_bytes(
                       len(r.prompt) + r.max_new_tokens) for r in sched.finished))
    del sched
    gc.collect()
    return run


def _slot_cache_bytes(cfg, slots: int, cache_len: int) -> int:
    """Device bytes of the slot map's fp32 cache: K and V of ``slots`` rows
    of each layer's cache length."""
    from repro_torch.models import blocks
    row = cfg.num_kv_heads * cfg.resolved_head_dim * 4
    return sum(2 * slots * blocks.cache_len(spec, cache_len) * row
               for spec in cfg.layer_specs())


def _wave_ms(params, cfg, ctx, cache_len: int, filled: int) -> tuple:
    """Device ms of one warm 4-slot decode wave, paged (its graph on a pool
    holding 4 requests of ``filled`` tokens) and on the slot map (its graph
    on its static cache)."""
    import torch
    from repro_torch.serving import engine
    from repro_torch.serving.paged_cache import PagedCachePool

    pool = PagedCachePool(params, cfg, ctx, 4, cache_len, PAGE)
    rps = []
    for _ in range(4):
        rp = pool.ops.new_request()
        for b in range(-(-filled // PAGE)):
            pool.ops.ensure_block(rp, pool.groups[0], b)
        pool.ops.alloc_state(rp)
        pool.prepare_decode_write(rp, filled)       # the page the wave writes
        rps.append(rp)
    tok = pool._ids([[1]] * 4)
    args = (pool._tables(rps), pool._write_pages(rps, [filled] * 4),
            pool._state_blocks(rps), pool._ids([filled] * 4), tok)
    paged, _, note_p = device_ms(lambda: pool._decode(params, pool.pools, *args))
    step = engine.get_decode_step(cfg, ctx)
    holder = _Holder()
    own = step.static_cache(engine.init_serve_cache(params, cfg, 4, cache_len), holder)
    slot, _, note_s = device_ms(lambda: step(params, own, tok))
    del own, holder, pool
    torch.cuda.empty_cache()
    return paged, slot, note_p + note_s


def paged_phase(served: dict, card: str) -> dict:
    """The paged serving path on the serve phase's weights: (a) the serve
    trace at 16-token pages against a slot-map run, (b) prefix reuse on a
    shared system prompt at Mixtral's whole window, (c) preemption under a
    tight budget, and an injected fault at the preemption's spill.  Returns
    the grouped kernels' launches over the paged runs."""
    phase("serve (paged)")
    import numpy as np
    import torch
    from repro_torch.core import memory_model as mm
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.serving import engine

    params, cfg, ctx = served["params"], served["cfg"], served["ctx"]
    n_moe = sum(1 for spec in cfg.layer_specs() if spec.ffn == "moe")
    cache_bytes = lambda n: mm.decode_cache_bytes(cfg, n, dtype_bytes=2)  # noqa: E731
    runs = {}

    # (a) the slot map and the paged cache on the serve trace, every sampled
    # logits row kept, then a warm run of each on the graphs the first ones
    # captured: the counts start at 0 after the slot-map runs
    paged_args = SERVE_ARGS + ["--page-size", str(PAGE)]
    logits = {"slot map": {}, "paged": {}}
    runs["slot map"] = _paged_run(SERVE_ARGS, params, record=logits["slot map"])
    runs["slot map, warm"] = _paged_run(SERVE_ARGS, params)
    counters = (gm.grouped_swiglu, gm.grouped_matmul)
    for fn in counters:
        fn.launches = 0
    runs["paged"] = _paged_run(paged_args, params, record=logits["paged"])
    runs["paged, warm"] = _paged_run(paged_args, params)
    a = runs["paged"]
    want = (served["streams"], served["order"])
    for name, r in runs.items():
        if (r["streams"], r["order"]) != want:
            raise SystemExit(f"the {name} run's streams or admission order differ "
                             f"from the serve phase's")
    rows = logits["slot map"]
    diff = [k for k in rows if not np.array_equal(rows[k], logits["paged"].get(k))]
    if diff or rows.keys() != logits["paged"].keys():
        raise SystemExit(f"paged logits differ from the slot map's at {diff[:4]} "
                         f"of {len(rows)} sampled rows")
    if a["captures"] != 1 or a["graphs"] != 1:
        raise SystemExit(f"the paged decode wave captured {a['captures']} graphs "
                         f"over {a['metrics']['decode_waves']} waves: every warm "
                         f"wave must replay one graph")
    m = a["metrics"]
    scfg = a["scfg"]
    print(f"{card}: (a) serve trace, pages of {PAGE}, cache_len {scfg.cache_len}: "
          f"streams and admission order equal the serve phase's; all {len(rows)} "
          f"sampled logits rows bit-equal to the slot map's; {m['decode_waves']} "
          f"waves on 1 paged decode graph (captured in {a['capture_s']:.3f} s)",
          flush=True)
    for name, r in runs.items():
        mr = r["metrics"]
        print(f"{card}: (a) {name} run: {mr['tok_per_s']:.1f} tok/s, p50 "
              f"{mr['latency_p50_s']:.3f} s, p99 {mr['latency_p99_s']:.3f} s, "
              f"{1e3 * mr['elapsed_s'] / r['passes']:.2f} ms a pass, "
              f"max_memory_allocated {r['peak'] / 1e9:.3f} GB", flush=True)
    print(f"{card}: (a) modeled (bf16): page_hwm_bytes {m['page_hwm_bytes'] / 1e6:.3f} "
          f"MB against the slot map's {m['max_occupancy']} x decode_cache_bytes = "
          f"{m['max_occupancy'] * cache_bytes(scfg.cache_len) / 1e6:.3f} MB; on the "
          f"card (fp32): the page pools {a['cache_bytes'] / 1e6:.3f} MB against the "
          f"slot map's cache {runs['slot map']['cache_bytes'] / 1e6:.3f} MB", flush=True)

    # (b) prefix reuse at the whole window, with the trie and without
    base = SERVE_ARGS + ["--page-size", str(PAGE), "--max-slots", str(PREFIX_SLOTS),
                         "--cache-len", str(PREFIX_CACHE_LEN)]
    for name in ("prefix", "no prefix", "prefix, warm", "no prefix, warm"):
        flags = ["--prefix-cache"] if name.startswith("prefix") else []
        runs[name] = _paged_run(base + flags, params, trace=_prefix_trace(cfg))
    pm = runs["prefix"]["metrics"]
    if any(runs[k]["streams"] != runs["prefix"]["streams"]
           for k in ("no prefix", "prefix, warm", "no prefix, warm")):
        raise SystemExit("prefix reuse changed the token streams")
    if pm["prefix_hits"] < PREFIX_HITS or not pm["prefix_tokens_reused"]:
        raise SystemExit(f"prefix reuse hit {pm['prefix_hits']} of 8 requests "
                         f"(at least {PREFIX_HITS}), reusing "
                         f"{pm['prefix_tokens_reused']} tokens")
    for name in ("prefix", "no prefix", "prefix, warm", "no prefix, warm"):
        r = runs[name]
        mr = r["metrics"]
        print(f"{card}: (b) {name}: {mr['tok_per_s']:.1f} tok/s, p50 "
              f"{mr['latency_p50_s']:.3f} s, p99 {mr['latency_p99_s']:.3f} s, "
              f"{mr['prefill_chunks']} prefill chunks, {mr['decode_waves']} waves, "
              f"modeled (bf16) page_hwm_bytes {mr['page_hwm_bytes'] / 1e6:.3f} MB "
              f"against the slot map's {mr['max_occupancy']} x decode_cache_bytes = "
              f"{mr['max_occupancy'] * cache_bytes(PREFIX_CACHE_LEN) / 1e6:.3f} MB; on "
              f"the card (fp32) the page pools {r['cache_bytes'] / 1e6:.3f} MB against "
              f"the slot map's {PREFIX_SLOTS}-slot cache "
              f"{_slot_cache_bytes(cfg, PREFIX_SLOTS, PREFIX_CACHE_LEN) / 1e6:.3f} MB; "
              f"max_memory_allocated {r['peak'] / 1e9:.3f} GB", flush=True)
    print(f"{card}: (b) prefix hits {pm['prefix_hits']} of 8, "
          f"{pm['prefix_tokens_reused']} tokens reused; streams equal without the "
          f"trie; decode graph captured in {runs['prefix']['capture_s']:.3f} s",
          flush=True)

    # (c) preemption under a budget of about two requests' worst case
    per_req = runs["prefix"]["worst_case"]          # (c) has (b)'s lengths
    floor = mm.serving_paged_peak_bytes(cfg, page_bytes=0, decode_tokens=PREFIX_SLOTS,
                                        prefill_tokens=scfg.prefill_chunk)
    budget = floor + BUDGET_REQUESTS * per_req
    slot_fit = 0
    while mm.serving_peak_bytes(cfg, requests=slot_fit + 1, cache_len=PREFIX_CACHE_LEN,
                                decode_tokens=PREFIX_SLOTS,
                                prefill_tokens=scfg.prefill_chunk) <= budget:
        slot_fit += 1
    tight = base + ["--prefix-cache", "--preemption", "--budget-gb", repr(budget / 1e9)]
    spill, restore, steps = [], [], []
    runs["budget"] = _paged_run(tight, params, trace=_prefix_trace(cfg, priorities=True),
                                spill=spill,
                                restore=restore, preempt_steps=steps)
    cm = runs["budget"]["metrics"]
    if cm["preemptions"] < 1 or runs["budget"]["streams"] != runs["prefix"]["streams"]:
        raise SystemExit(f"under the budget: {cm['preemptions']} preemptions, streams "
                         f"{'equal' if runs['budget']['streams'] == runs['prefix']['streams'] else 'differ'}")
    print(f"{card}: (c) budget {budget / 1e9:.4f} GB (weights + activations "
          f"{floor / 1e9:.4f} GB + {BUDGET_REQUESTS} x {per_req / 1e6:.3f} MB worst "
          f"case): {cm['preemptions']} preemptions, every request finished, streams "
          f"equal the unconstrained run's; max_occupancy {cm['max_occupancy']} under "
          f"the paged admission model against {slot_fit} requests under the slot "
          f"map's (both modeled bf16 bytes; on the card the fp32 pools hold "
          f"{runs['budget']['cache_bytes'] / 1e6:.3f} MB whatever the budget, the "
          f"slot map's cache {_slot_cache_bytes(cfg, PREFIX_SLOTS, PREFIX_CACHE_LEN) / 1e6:.3f}"
          f" MB); spill "
          f"{1e3 * sum(spill) / len(spill):.3f} ms and restore "
          f"{1e3 * sum(restore) / max(len(restore), 1):.3f} ms a preemption "
          f"({len(spill)} / {len(restore)}); {cm['tok_per_s']:.1f} tok/s, p50 "
          f"{cm['latency_p50_s']:.3f} s, p99 {cm['latency_p99_s']:.3f} s, "
          f"max_memory_allocated {runs['budget']['peak'] / 1e9:.3f} GB", flush=True)
    spec = f"oom@{steps[0]}"
    runs["fault"] = _paged_run(tight + ["--inject", spec], params,
                               trace=_prefix_trace(cfg, priorities=True))
    fm = runs["fault"]["metrics"]
    if (fm["faults"] < 1 or fm["preemptions"] < 1
            or runs["fault"]["streams"] != runs["prefix"]["streams"]):
        raise SystemExit(f"--inject {spec}: {fm['faults']} faults, "
                         f"{fm['preemptions']} preemptions; streams must equal")
    print(f"{card}: (c) --inject {spec} at the first preemption's spill: "
          f"{fm['faults']} fault, {fm['preemptions']} preemptions after it, every "
          f"request finished with the same streams, allocator audit clean", flush=True)

    launches = {fn.__name__: fn.launches for fn in counters}
    passes = sum(r["passes"] for name, r in runs.items()
                 if not name.startswith("slot map"))
    for name, n in launches.items():
        if n != n_moe * passes:
            raise SystemExit(f"{name} launched {n} times over the paged runs; they "
                             f"run it {n_moe * passes} times (once per MoE layer per pass)")
    del runs
    for cache_len, filled in ((scfg.cache_len, 64), (PREFIX_CACHE_LEN, 64)):
        paged, slot, note = _wave_ms(params, cfg, ctx, cache_len, filled)
        print(f"{card}: warm 4-slot decode wave at cache_len {cache_len} ({filled} "
              f"tokens each): paged {paged:.4f} ms, slot map {slot:.4f} ms (device "
              f"time of the graph replays){note}", flush=True)
    engine.clear_step_cache()
    torch.cuda.empty_cache()
    return launches


# the expert-aware phase: the serve trace in the reference test's five slot-
# map modes and two paged ones, then (c) admission at a budget between the
# all-resident model's peaks for BUDGET_AT and BUDGET_AT + 1 requests
EXPERT_MODES = (
    ("default", []),
    ("wave 2", ["--wave-size", "2"]),
    ("wave 2 + batching", ["--wave-size", "2", "--expert-batching"]),
    ("wave 2 + batching + resident 2", ["--wave-size", "2", "--expert-batching",
                                        "--resident-experts", "2"]),
    ("batching + resident 2 + probe", ["--expert-batching", "--resident-experts", "2",
                                       "--probe-router"]))
EXPERT_PAGED = (
    ("paged, wave 2 + batching + resident 2",
     ["--page-size", str(PAGE), "--wave-size", "2", "--expert-batching",
      "--resident-experts", "2"]),
    ("paged + prefix, batching + resident 2",
     ["--page-size", str(PAGE), "--prefix-cache", "--expert-batching",
      "--resident-experts", "2"]))
BUDGET_AT = 2
RESTORE_SAMPLES = 6


def weights_digest(params) -> list:
    """Per weight and per leading row (an expert, for the expert weights):
    the sum and the sum of squares of its 16-bit words, exact in int64 on
    the card.  A zeroed, swapped or altered row changes it."""
    import torch
    from repro_torch.serving import engine
    out = []
    with torch.no_grad():
        for t in engine.leaves(params):
            words = t.reshape(t.shape[0] if t.dim() > 1 else 1, -1).view(torch.int16)
            for rows in words.split(64):
                w = rows.long()
                out.append(torch.stack([w.sum(1), (w * w).sum(1)]).cpu())
    return out


def _captures() -> dict:
    from repro_torch.serving import engine
    return {key: step.captures for key, step in engine._STEP_CACHE.items()}


def _expert_run(argv, params, record=None) -> dict:
    """One run of the launcher's scheduler on ``params``, closed at the end
    (the residency tier hands the weights back); the streams, metrics, the
    residency's mirror seconds and each compiled step's captures before and
    after."""
    import gc

    import torch
    from repro_torch.launch import serve

    sched, trace = serve.setup(serve.parse_args(argv), params=params)
    if record is not None:
        _recording(sched, record)
    torch.cuda.synchronize()
    before = _captures()
    try:
        m = sched.run(trace)
    finally:
        sched.close()
    torch.cuda.synchronize()
    run = {"metrics": m, "before": before, "after": _captures(),
           "streams": [r.out for r in sorted(sched.finished, key=lambda r: r.rid)],
           "passes": m["decode_waves"] + m["prefill_chunks"] + m["demand_reruns"],
           "mirror_s": sched.residency.mirror_s if sched.residency else None,
           "mirror_bytes": sched.residency.mirror_bytes if sched.residency else 0}
    unfinished = [r.rid for r in sched.finished if len(r.out) != r.max_new_tokens]
    if sched.queue or sched.active or unfinished or m["nonfinite_logits"] or m["shed"]:
        raise SystemExit(f"{' '.join(argv[-6:])}: not every request finished with "
                         f"finite logits (short {unfinished}, shed {m['shed']})")
    del sched
    gc.collect()
    return run


def _restore_ms(params, cfg) -> tuple:
    """Seconds of one expert-layer restore (w1, w3 and w2 rows of one expert
    from the pinned mirror) over RESTORE_SAMPLES cold experts, and the
    mirror's build seconds, on a residency of its own."""
    import torch
    from repro_torch.serving.residency import ExpertResidency

    res = ExpertResidency(params, cfg, 2)
    try:
        res.offload_cold(params)
        times = []
        cold = [(j, e) for j in range(res.num_layers) for e in range(res.num_experts)
                if e not in res.resident[j]][:RESTORE_SAMPLES]
        for pair in cold:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res.ensure(params, [pair])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        res.close(params)
    return times, res.mirror_s, res.mirror_bytes


def expert_phase(served: dict, card: str) -> dict:
    """Expert-aware serving on the serve phase's weights: (a) the serve trace
    in five slot-map modes and (b) two paged ones, streams equal to the serve
    phase's and every sampled logits row bit-equal to the default run's; (c)
    admission at a budget between the all-resident model's peaks for
    BUDGET_AT and BUDGET_AT + 1 requests; (d) the counters, a restore's rate,
    the mirror's build time and a masked wave's device time; (e) the weights
    handed back bit for bit.  Returns the grouped kernels' launches over the
    phase's runs."""
    phase("serve (expert-aware)")
    import numpy as np
    import torch
    from repro_torch.core import memory_model as mm
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.serving import engine

    t_phase = time.perf_counter()
    params, cfg, ctx = served["params"], served["cfg"], served["ctx"]
    n_moe = sum(1 for spec in cfg.layer_specs() if spec.ffn == "moe")
    digest = weights_digest(params)
    counters = (gm.grouped_swiglu, gm.grouped_matmul)
    for fn in counters:
        fn.launches = 0
    rows, runs = {}, {}
    for name, flags in EXPERT_MODES + EXPERT_PAGED:
        rows[name] = {}
        runs[name] = _expert_run(SERVE_ARGS + flags, params, record=rows[name])
    # (c) the budget: between the all-resident model's peaks at BUDGET_AT and
    # BUDGET_AT + 1 requests, at the serve trace's shapes
    scfg = served["scfg"]
    kw = dict(cache_len=scfg.cache_len, decode_tokens=scfg.max_slots,
              prefill_tokens=scfg.prefill_chunk, dtype_bytes=scfg.dtype_bytes)
    lo, hi = (mm.serving_peak_bytes(cfg, requests=n, **kw)
              for n in (BUDGET_AT, BUDGET_AT + 1))
    budget = ["--budget-gb", repr((lo + hi) / 2e9)]
    for name, flags in (("budget, all resident", budget),
                        ("budget, resident 2", budget + ["--resident-experts", "2"])):
        runs[name] = _expert_run(SERVE_ARGS + flags, params)
    launches = {fn.__name__: fn.launches for fn in counters}
    torch.cuda.synchronize()
    t_runs = time.perf_counter() - t_phase

    want = served["streams"]
    base = rows["default"]
    for name, r in runs.items():
        if r["streams"] != want:
            raise SystemExit(f"the {name} run's streams differ from the serve phase's")
        if name in rows:
            diff = [k for k in base if not np.array_equal(base[k], rows[name].get(k))]
            if diff or rows[name].keys() != base.keys():
                raise SystemExit(f"the {name} run's logits differ from the default "
                                 f"run's at {diff[:4]} of {len(base)} sampled rows")
        grown = {str(k[0]): (r["before"][k], r["after"][k]) for k in r["before"]
                 if r["before"][k] and r["after"][k] != r["before"][k]}
        if r["metrics"].get("residency") and grown:
            raise SystemExit(f"the {name} run captured graphs of warm steps across "
                             f"its restores: {grown}")
    passes = sum(r["passes"] for r in runs.values())
    for name, n in launches.items():
        if n != n_moe * passes:
            raise SystemExit(f"{name} launched {n} times over the expert-aware runs; "
                             f"they run it {n_moe * passes} times (once per MoE layer "
                             f"per pass and re-run)")
    full, tier = (runs[k]["metrics"] for k in ("budget, all resident",
                                               "budget, resident 2"))
    if tier["max_occupancy"] <= full["max_occupancy"]:
        raise SystemExit(f"at {(lo + hi) / 2e9:.3f} GB the tier admitted "
                         f"{tier['max_occupancy']} at once, all-resident "
                         f"{full['max_occupancy']}")
    after = weights_digest(params)
    if len(after) != len(digest) or any(not torch.equal(a, b)
                                        for a, b in zip(digest, after)):
        raise SystemExit("the weights differ from the serve phase's after the phase")

    nrows = len(base)
    print(f"{card}: (a, b) serve trace in {len(rows)} modes: streams equal the serve "
          f"phase's; all {nrows} sampled logits rows of every mode bit-equal to the "
          f"default run's (members of masked waves and clean runs after demand "
          f"restores); warm steps captured no graph across restores", flush=True)
    for name, r in runs.items():
        m = r["metrics"]
        res = m.get("residency")
        line = (f"{card}: {name}: {m['tok_per_s']:.1f} tok/s, p50 "
                f"{m['latency_p50_s']:.3f} s, p99 {m['latency_p99_s']:.3f} s, "
                f"{m['decode_waves']} waves, {m['prefill_chunks']} chunks, "
                f"{1e3 * m['elapsed_s'] / r['passes']:.2f} ms a pass, max_occupancy "
                f"{m['max_occupancy']}, modeled peak {m['modeled_peak_bytes'] / 1e9:.3f} GB")
        if m["expert_waves"]:
            line += (f"; mean_distinct_experts {m['mean_distinct_experts']:.3f}, "
                     f"mean_wave_occupancy {m['mean_wave_occupancy']:.3f}, "
                     f"forced_includes {m['forced_includes']}")
        if res:
            line += (f"; restores {res['restores']} (demand_restores "
                     f"{res['demand_restores']}), offloads {res['offloads']}, hwm "
                     f"{res['resident_experts_hwm']}, prefetch_hits "
                     f"{m['prefetch_hits']}, prefetch_misses {m['prefetch_misses']}, "
                     f"demand_reruns {m['demand_reruns']}; pinned mirror "
                     f"{r['mirror_bytes'] / 1e9:.3f} GB built in {r['mirror_s']:.3f} s")
        print(line, flush=True)
    print(f"{card}: (c) budget {(lo + hi) / 2e9:.4f} GB (all-resident model "
          f"{lo / 1e9:.4f} / {hi / 1e9:.4f} GB at {BUDGET_AT} / {BUDGET_AT + 1} "
          f"requests): max_occupancy {tier['max_occupancy']} with 2 resident experts "
          f"against {full['max_occupancy']}, 0 shed, streams equal", flush=True)

    # (d) one expert-layer restore, the mirror's build, a masked wave
    times, mirror_s, mirror_bytes = _restore_ms(params, cfg)
    per = mm.expert_weight_bytes(cfg)
    ms = sorted(1e3 * t for t in times)
    print(f"{card}: (d) one expert-layer restore ({per / 1e6:.1f} MB, pinned host -> "
          f"card): {ms[len(ms) // 2]:.3f} ms median ({ms[0]:.3f}-{ms[-1]:.3f} over "
          f"{len(ms)}), {per / (ms[len(ms) // 2] * 1e6):.2f} GB/s; the pinned mirror "
          f"({mirror_bytes / 1e9:.3f} GB) built in {1e3 * mirror_s:.1f} ms", flush=True)
    masked = engine.get_decode_step_masked(cfg, ctx)
    plain = engine.get_decode_step(cfg, ctx)
    holder = _Holder()
    mk = masked.static_cache(engine.init_serve_cache(params, cfg, 4, scfg.cache_len),
                             holder)
    pl = plain.static_cache(engine.init_serve_cache(params, cfg, 4, scfg.cache_len),
                            holder)
    tok = torch.ones((4, 1), dtype=torch.long, device=ctx.device)
    mask = torch.tensor([True, False, True, False], device=ctx.device)
    pos = (mk["pos"].clone(), pl["pos"].clone())

    def masked_wave():
        mk["pos"].copy_(pos[0])
        masked(params, mk, tok, mask)

    def plain_wave():
        pl["pos"].copy_(pos[1])
        plain(params, pl, tok)
    m_ms, m_host, note_m = device_ms(masked_wave)
    p_ms, p_host, note_p = device_ms(plain_wave)
    print(f"{card}: (d) warm 4-slot decode wave, masked (2 members) / slot map: "
          f"device {m_ms:.4f} / {p_ms:.4f} ms, host {m_host:.4f} / {p_host:.4f} ms"
          f"{note_m}{note_p}", flush=True)
    print(f"{card}: (e) every weight's digest equals the serve phase's after "
          f"{sum(1 for r in runs.values() if r['metrics'].get('residency'))} "
          f"residency runs; expert-aware runs {t_runs:.1f} s, the phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del mk, pl, holder
    engine.clear_step_cache()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()                    # the pinned mirrors' cached blocks
    return launches


# the serve (hybrid) phase: the serve trace on full-width Jamba-1.5-Large cut
# to its period's first 4 layers (mamba/dense, mamba/MoE, mamba/dense,
# attention/MoE) and on Mamba2-130m whole
HYBRID_ARGS = (["--arch", "jamba-1.5-large-398b", "--layers", "4"]
               + SERVE_ARGS[SERVE_ARGS.index("--requests"):])
MAMBA_ARGS = ["--arch", "mamba2-130m"] + SERVE_ARGS[SERVE_ARGS.index("--requests"):]


def _state_leaves(sched) -> list:
    """The slot pool's mamba state tensors."""
    return [t for layer in sched.cache["layers"] if "ssm" in layer
            for t in layer["ssm"].values()]


def _idle_share(args, params) -> tuple:
    """One run under torch.profiler: (run, device busy ms, idle share %)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    r = _serve_run(args, params, profiler=prof)
    busy = sum(us for _, _, us in device_kernels(prof)) / 1e3
    return r, busy, 100 - 100 * busy / (1e3 * r["metrics"]["elapsed_s"])


def _turns(argv, params, card: str, label: str, want=None) -> list:
    """The trace eager and compiled in turns on ``params``, then one
    profiled run each way: streams equal across runs (and ``want``);
    prints each run's numbers.  Returns the runs."""
    from repro_torch.launch import serve
    modes = {e: serve.parse_args(argv + (["--eager"] if e else [])) for e in (False, True)}
    runs = [_serve_run(modes[e], params) for e in (True, False, True, False)]
    idle = {}
    for e in (False, True):
        r, busy, idle[e] = _idle_share(modes[e], params)
        runs.append(r)
    want = runs[0]["streams"] if want is None else want
    for r in runs:
        if r["streams"] != want:
            raise SystemExit(f"{label}: the {'eager' if r['eager'] else 'compiled'} run's "
                             f"streams differ from the first run's")
        if not r["eager"] and r["captures"]:
            raise SystemExit(f"{label}: a warm compiled run captured a graph")
    for r in runs:
        m = r["metrics"]
        print(f"{card}: {label} warm {'eager' if r['eager'] else 'compiled'} run: "
              f"{r['ms_per_pass']:.2f} ms a pass ({r['passes']} passes), "
              f"{m['tok_per_s']:.1f} tok/s, p50 {m['latency_p50_s']:.3f} s, p99 "
              f"{m['latency_p99_s']:.3f} s, device idle {idle[r['eager']]:.1f}% "
              f"(profiled run), max_memory_allocated {r['peak'] / 1e9:.3f} GB against "
              f"the modeled peak {m['modeled_peak_bytes'] / 1e9:.3f} GB", flush=True)
    print(f"{card}: {label}: streams equal over {len(runs)} runs, eager and "
          f"compiled in turns; warm compiled runs captured no graph", flush=True)
    return runs


def _wave_checked(sched, checks: list) -> None:
    """Wrap the scheduler's member wave: every non-member slot's mamba state
    and conv tail must come back bit for bit (read on the host)."""
    import torch
    run_wave = sched._run_wave

    def checked(members, mask):
        others = torch.as_tensor([s for s in range(len(mask)) if not mask[s]],
                                 dtype=torch.long, device=sched.ctx.device)
        before = [t[others].cpu() for t in _state_leaves(sched)]
        out = run_wave(members, mask)
        after = [t[others].cpu() for t in _state_leaves(sched)]
        if any(not torch.equal(a, b) for a, b in zip(before, after)):
            raise SystemExit(f"a masked wave over slots {members} changed a "
                             f"non-member's mamba state")
        checks.append(len(others))
        return out
    sched._run_wave = checked


def hybrid_phase(card: str) -> dict:
    """State-carrying models on the serving paths: (a) full-width Jamba at
    4 layers through the launcher, then eager and compiled in turns; (c)
    the same weights from pages (the serve trace against the slot map, the
    shared-stem trace with the trie, a tight budget with preemption); (d)
    waves of 2, every non-member's state checked across each wave; (b)
    Mamba2-130m whole, eager and compiled in turns.  Returns the grouped
    kernels' launches over the phase."""
    phase("serve (hybrid)")
    import gc

    import numpy as np
    import torch
    from repro_torch.core import memory_model as mm
    from repro_torch.kernels import grouped_mlp as gm
    from repro_torch.launch import serve
    from repro_torch.serving import engine

    t_phase = time.perf_counter()
    gc.collect()                          # the Mixtral phases' weights
    torch.cuda.empty_cache()
    counters = (gm.grouped_swiglu, gm.grouped_matmul)
    for fn in counters:
        fn.launches = 0
    passes = 0

    # (a) the launcher's run, compiled
    torch.cuda.reset_peak_memory_stats()
    sched, m = serve.main(HYBRID_ARGS)
    torch.cuda.synchronize()
    params, cfg, ctx, scfg = sched.params, sched.cfg, sched.ctx, sched.scfg
    info = engine.step_cache_info()
    unfinished = [r.rid for r in sched.finished if len(r.out) != r.max_new_tokens]
    if m["requests"] != 8 or unfinished or m["nonfinite_logits"] or not info["graphs"]:
        raise SystemExit(f"Jamba: {m['requests']}/8 requests done, short {unfinished}, "
                         f"{m['nonfinite_logits']} non-finite rows, {info['graphs']} graphs")
    want = [r.out for r in sorted(sched.finished, key=lambda r: r.rid)]
    passes += m["decode_waves"] + m["prefill_chunks"]
    n_moe = sum(1 for spec in cfg.layer_specs() if spec.ffn == "moe")
    weights = sum(t.nbytes for t in engine.leaves(params))
    counts = mm.param_counts(cfg, mm.Parallelism())
    layer_params = sum(v for k, v in counts.items() if k not in ("embed", "lm_head"))
    mamba_bytes = sum(t.nbytes for layer in params["layers"] if "A_log" in layer["mixer"]
                      for t in engine.leaves(layer["mixer"]))
    read = weights - params["embed"].nbytes       # a decode pass: all but the table
    print(f"{card}: (a) Jamba {cfg.num_layers} layers ({[s.mixer + '/' + s.ffn for s in cfg.layer_specs()]}), "
          f"bf16: {weights / 1e9:.3f} GB of weights allocated; the memory model's "
          f"layer_params {layer_params * 2 / 1e9:.3f} GB + embed/head "
          f"{(counts['embed'] + counts['lm_head']) * 2 / 1e9:.3f} GB (its mamba term "
          f"{counts['mamba'] * 2 / 1e9:.3f} GB against {mamba_bytes / 1e9:.3f} GB "
          f"allocated: the reference's B/C count); {info['captures']} graphs captured "
          f"in {info['capture_s']:.3f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    del sched
    gc.collect()
    runs = _turns(HYBRID_ARGS, params, card, "(a) Jamba", want)
    passes += sum(r["passes"] for r in runs)
    # (c) pages: the serve trace against the slot map, logits rows bit-equal
    logits = {"slot map": {}, "paged": {}}
    slot = _paged_run(HYBRID_ARGS, params, record=logits["slot map"])
    paged = _paged_run(HYBRID_ARGS + ["--page-size", str(PAGE)], params,
                       record=logits["paged"])
    passes += slot["passes"] + paged["passes"]
    rows = logits["slot map"]
    diff = [k for k in rows if not np.array_equal(rows[k], logits["paged"].get(k))]
    if slot["streams"] != want or paged["streams"] != want or diff \
            or rows.keys() != logits["paged"].keys():
        raise SystemExit(f"Jamba paged: streams or logits rows differ from the slot "
                         f"map's ({diff[:4]} of {len(rows)})")
    print(f"{card}: (c) Jamba serve trace, pages of {PAGE}: streams equal the slot "
          f"map's, all {len(rows)} sampled logits rows bit-equal; modeled (bf16) state "
          f"block {paged['state_block_bytes'] / 1e6:.3f} MB a request beside page "
          f"high-watermark {paged['metrics']['page_hwm_bytes'] / 1e6:.3f} MB; on the "
          f"card (fp32) the state pools {paged['state_pool_bytes'] / 1e6:.3f} MB beside "
          f"the K/V pools {(paged['cache_bytes'] - paged['state_pool_bytes']) / 1e6:.3f} "
          f"MB; {paged['metrics']['tok_per_s']:.1f} tok/s paged against "
          f"{slot['metrics']['tok_per_s']:.1f} on the slot map", flush=True)
    base = HYBRID_ARGS + ["--max-slots", str(PREFIX_SLOTS), "--cache-len",
                          str(PREFIX_CACHE_LEN)]
    slot = _paged_run(base, params, trace=_prefix_trace(cfg))
    trie = _paged_run(base + ["--page-size", str(PAGE), "--prefix-cache"], params,
                      trace=_prefix_trace(cfg))
    passes += slot["passes"] + trie["passes"]
    pm = trie["metrics"]
    if trie["streams"] != slot["streams"] or pm["prefix_hits"] < PREFIX_HITS:
        raise SystemExit(f"Jamba prefix reuse: {pm['prefix_hits']} hits of 8, streams "
                         f"{'equal' if trie['streams'] == slot['streams'] else 'differ'}")
    per_req = trie["worst_case"]
    floor = mm.serving_paged_peak_bytes(cfg, page_bytes=0, decode_tokens=PREFIX_SLOTS,
                                        prefill_tokens=scfg.prefill_chunk)
    budget = floor + BUDGET_REQUESTS * per_req
    spill, restore = [], []
    tight = _paged_run(base + ["--page-size", str(PAGE), "--prefix-cache", "--preemption",
                               "--budget-gb", repr(budget / 1e9)], params,
                       trace=_prefix_trace(cfg, priorities=True), spill=spill,
                       restore=restore)
    passes += tight["passes"]
    cm = tight["metrics"]
    if cm["preemptions"] < 1 or tight["streams"] != slot["streams"]:
        raise SystemExit(f"Jamba under the budget: {cm['preemptions']} preemptions, "
                         f"streams must equal the slot map's")
    print(f"{card}: (c) Jamba shared {PREFIX_STEM}-token stem at cache_len "
          f"{PREFIX_CACHE_LEN}: prefix hits {pm['prefix_hits']} of 8 "
          f"({pm['prefix_tokens_reused']} tokens reused, each resuming from its trie "
          f"node's state snapshot), streams equal the slot map's; budget "
          f"{budget / 1e9:.4f} GB ({BUDGET_REQUESTS} x {per_req / 1e6:.3f} MB worst case): "
          f"{cm['preemptions']} preemptions, streams equal, spill "
          f"{1e3 * sum(spill) / max(len(spill), 1):.3f} ms and restore "
          f"{1e3 * sum(restore) / max(len(restore), 1):.3f} ms a preemption (pages and "
          f"state block); {cm['tok_per_s']:.1f} tok/s", flush=True)

    # (d) waves of 2, no residency: every non-member's state checked
    checks, rows = [], {}
    wave = serve.parse_args(HYBRID_ARGS + ["--wave-size", "2"])
    sched, trace = serve.setup(wave, params=params)
    _wave_checked(sched, checks)
    _recording(sched, rows)
    mw = sched.run(trace)
    sched.close()
    got = [r.out for r in sorted(sched.finished, key=lambda r: r.rid)]
    passes += mw["decode_waves"] + mw["prefill_chunks"] + mw["demand_reruns"]
    del sched
    gc.collect()
    if got != want or not mw["expert_waves"] or not sum(checks):
        raise SystemExit(f"Jamba waves of 2: streams {'equal' if got == want else 'differ'}, "
                         f"{mw['expert_waves']} waves, {sum(checks)} non-member checks")
    print(f"{card}: (d) Jamba waves of 2: {mw['expert_waves']} masked waves, streams "
          f"equal the default run's; every non-member's mamba state and conv tail "
          f"bit-equal across its wave ({sum(checks)} slot checks on the host); "
          f"mean_distinct_experts {mw['mean_distinct_experts']:.3f}, "
          f"{mw['tok_per_s']:.1f} tok/s", flush=True)

    launches = {fn.__name__: fn.launches for fn in counters}
    for name, n in launches.items():
        if n != n_moe * passes:
            raise SystemExit(f"{name} launched {n} times over the Jamba runs; they run "
                             f"it {n_moe * passes} times (once per MoE layer per pass)")
    # a decode wave's device time, after the path's counts were read
    step = engine.get_decode_step(cfg, ctx)
    holder = _Holder()
    own = step.static_cache(engine.init_serve_cache(params, cfg, scfg.max_slots,
                                                    scfg.cache_len), holder)
    tok = torch.ones((scfg.max_slots, 1), dtype=torch.long, device=ctx.device)
    wave_ms, wave_host, _ = device_ms(lambda: step(params, own, tok))
    del own, holder
    print(f"{card}: (a) Jamba warm 4-slot decode wave: device {wave_ms:.4f} ms, host "
          f"{wave_host:.4f} ms; it reads {read / 1e9:.3f} GB of weights, at least "
          f"{1e3 * read / HBM_BYTES_PER_S:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"({100 * 1e3 * read / HBM_BYTES_PER_S / wave_ms:.1f}% of the bound)", flush=True)

    del params, runs, step
    engine.clear_step_cache()
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Mamba2-130m, every layer at full width
    before = [fn.launches for fn in counters]
    torch.cuda.reset_peak_memory_stats()
    sched, m = serve.main(MAMBA_ARGS)
    params = sched.params
    unfinished = [r.rid for r in sched.finished if len(r.out) != r.max_new_tokens]
    if m["requests"] != 8 or unfinished or m["nonfinite_logits"]:
        raise SystemExit(f"Mamba2: {m['requests']}/8 requests done, short {unfinished}")
    want = [r.out for r in sorted(sched.finished, key=lambda r: r.rid)]
    print(f"{card}: (b) Mamba2-130m, {sched.cfg.num_layers} layers, "
          f"{sum(t.nbytes for t in engine.leaves(params)) / 1e9:.3f} GB bf16", flush=True)
    del sched
    gc.collect()
    _turns(MAMBA_ARGS, params, card, "(b) Mamba2-130m", want)
    if [fn.launches for fn in counters] != before:
        raise SystemExit("Mamba2-130m has no MoE layer, yet a grouped kernel launched")
    del params
    engine.clear_step_cache()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{card}: serve (hybrid) phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# encoder-decoder and patch inputs, and training on every family
# ---------------------------------------------------------------------------

ENCDEC_GEN = 32            # greedy decode steps a request
ENCDEC_PROFILED = 8        # steps of a profiled run: the profiler's own cost
                           # grows with the events it records
WHISPER_PROMPTS = (16, 32, 48, 64)
VLM_LAYERS, VLM_PROMPT = 8, 32
ENCDEC_PAGE = 16
# (label, arch, layers (0 = whole), seq_len, global batch, EP fused leg)
FAMILY_RUNS = (("Whisper-small", "whisper-small", 0, 448, 4, False),
               ("InternVL2-76B", "internvl2-76b", 2, 2048, 2, False),
               ("Mamba2-130m", "mamba2-130m", 0, 2048, 2, False),
               ("Jamba-1.5-Large", "jamba-1.5-large-398b", 1, 2048, 2, False),
               ("Llama-4-Scout-17B-16E", "llama4-scout-17b-a16e", 1, 1024, 2, True))
FAMILY_STEPS = 3


def _cat_rows(caches: list) -> dict:
    """One decode cache of the rows of ``caches`` (each a B=1 cache)."""
    import torch
    from repro_torch.serving import engine
    cols = zip(*[engine.leaves(c) for c in caches])
    return engine._fill(caches[0], iter([torch.cat(list(ts)) for ts in cols]))


def _greedy(step, params, cache, logits, n: int, profiler=None) -> dict:
    """``n`` greedy decode steps of ``step`` from ``cache`` and the
    prefill's ``logits``: tokens, every step's logits (copied off the
    graph's output buffer), ms a pass, and the device busy ms when
    ``profiler`` records the run."""
    import contextlib

    import torch
    nxt = logits[:, -1].argmax(-1)
    toks, out = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiler if profiler is not None else contextlib.nullcontext():
        for _ in range(n):
            toks.append(nxt)
            lg, cache = step(params, cache, nxt[:, None])
            out.append(lg.clone())
            nxt = lg[:, -1].argmax(-1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {"tokens": torch.stack(toks, 1).tolist(), "logits": out,
           "ms": 1e3 * wall / n, "tok_s": len(toks[0]) * n / wall}
    if profiler is not None:
        run["busy_ms"] = sum(us for _, _, us in device_kernels(profiler)) / 1e3 / n
    return run


def _encdec_turns(label: str, card: str, params, cfg, ctx, cache, logits,
                  model_bytes: float) -> dict:
    """Greedy decode of ``cache`` eagerly and through the decode graph in
    turns (eager, graph, eager, graph, then one profiled run of
    ``ENCDEC_PROFILED`` steps each way):
    token streams equal and every step's logits bit-equal across the runs;
    a warm graph run captures nothing.  Returns the last unprofiled graph
    run."""
    import torch
    from repro_torch.serving import engine
    from torch.profiler import ProfilerActivity, profile

    step = engine.get_decode_step(cfg, ctx)
    runs = []
    for graph, prof in ((False, False), (True, False), (False, False), (True, False),
                        (False, True), (True, True)):
        torch.cuda.reset_peak_memory_stats()
        holder = engine._Holder()
        c = engine.clone_cache(cache)
        fn = step.eager
        if graph:
            c, fn = step.static_cache(c, holder), step
        before = step.captures
        p = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
             if prof else None)
        r = _greedy(fn, params, c, logits, ENCDEC_PROFILED if prof else ENCDEC_GEN, p)
        r.update(graph=graph, captures=step.captures - before,
                 peak=torch.cuda.max_memory_allocated())
        runs.append(r)
        del c, holder
    first = runs[0]
    for r in runs:
        n = len(r["logits"])                 # a profiled run's first steps
        if [t[:n] for t in first["tokens"]] != r["tokens"] or any(
                not torch.equal(a, b) for a, b in zip(r["logits"], first["logits"])):
            raise SystemExit(f"{label}: a {'graph' if r['graph'] else 'eager'} run's "
                             f"streams or logits differ from the first eager run's")
        if r["graph"] and r is not runs[1] and r["captures"]:
            raise SystemExit(f"{label}: a warm graph run captured a graph")
    # the profiler slows the host many times over, so a profiled run's own
    # wall clock overstates idle time: its device ms a pass is held against
    # the same mode's last warm unprofiled run's ms a pass
    warm = {r["graph"]: r for r in runs if "busy_ms" not in r}
    for r in runs:
        idle = ""
        if "busy_ms" in r:
            ms = warm[r["graph"]]["ms"]
            idle = (f", device busy {r['busy_ms']:.3f} ms a pass (profiled), idle "
                    f"{100 - 100 * r['busy_ms'] / ms:.1f}% of the warm run's {ms:.3f} ms")
        print(f"{card}: {label} {'graph' if r['graph'] else 'eager'} decode"
              f"{' (capture included)' if r['captures'] else ''}: "
              f"{r['ms']:.3f} ms a pass ({len(r['tokens'])} rows), "
              f"{r['tok_s']:.1f} tok/s{idle}, max_memory_allocated "
              f"{r['peak'] / 1e9:.3f} GB against the model's weights + caches "
              f"{model_bytes / 1e9:.3f} GB", flush=True)
    print(f"{card}: {label}: streams equal and every step's logits bit-equal over "
          f"{len(runs)} runs, eager and graph in turns; warm graph runs captured "
          f"no graph", flush=True)
    return runs[3]


def _release() -> None:
    """Free the graphs, their static caches and the card's cached blocks
    once a model's weights are dropped."""
    import gc

    import torch
    from repro_torch.serving import engine
    engine.clear_step_cache()
    gc.collect()
    torch.cuda.empty_cache()


def _param_bytes(params) -> int:
    from repro_torch.serving import engine
    return sum(t.numel() * t.element_size() for t in engine.leaves(params))


def encdec_phase(card: str) -> None:
    """Full-width Whisper-small whole (12 encoder + 12 decoder layers) and
    InternVL2-76B's backbone cut to 8 of its 80 layers, bf16 weights from a
    seed: prefill and greedy decode eager and through the decode graph in
    turns; Whisper's requests also from 16-token pages, every logits row
    bit-equal to the slot map's."""
    phase("serve (enc-dec + VLM)")
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import memory_model as mm
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    from repro_torch.serving.paged_cache import CROSS, PagedCachePool

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    ctx = DistContext(device=dev)

    # (a) Whisper-small: 4 requests of 1500 frames and 16-64 prompt tokens,
    # each prefilled alone, decoded together (one row a request)
    cfg = get_config("whisper-small")
    params = transformer.init_params(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    rng = np.random.default_rng(0)
    cache_len = max(WHISPER_PROMPTS) + ENCDEC_GEN
    caches, firsts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for S in WHISPER_PROMPTS:
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                                           device=dev),
                 "frames": torch.as_tensor(rng.standard_normal(
                     (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32), device=dev)}
        logits, cache = engine.prefill(params, cfg, ctx, batch, cache_len)
        caches.append(engine.clone_cache(cache))
        firsts.append(logits.clone())
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache, first = _cat_rows(caches), torch.cat(firsts)
    if not bool(torch.isfinite(first).all()):
        raise SystemExit("Whisper-small: non-finite prefill logits")
    cross_bytes = sum(layer[n].numel() * layer[n].element_size()
                      for layer in cache["layers"] for n in CROSS)
    weights = _param_bytes(params)
    modeled = mm.decode_cache_bytes(cfg, cache_len, 4) * len(WHISPER_PROMPTS)
    print(f"{card}: Whisper-small whole: {weights / 1e9:.3f} GB of bf16 weights "
          f"(memory model {mm.serve_weight_bytes(cfg) / 1e9:.3f} GB); 4 prefills "
          f"(1500 frames, prompts {list(WHISPER_PROMPTS)}) {prefill_s:.2f} s cold; fp32 "
          f"cache of 4 requests {_fmt_bytes(sum(t.numel() * 4 for t in engine.leaves(cache)))}, "
          f"of it cross K/V {cross_bytes / 1e6:.1f} MB; decode_cache_bytes at fp32 "
          f"{modeled / 1e6:.1f} MB", flush=True)
    graph = _encdec_turns("Whisper-small", card, params, cfg, ctx, cache, first,
                          weights + modeled)

    # the same requests from 16-token pages: cross K/V in each request's
    # state block, every logits row bit-equal to the slot map's graph run
    pool = PagedCachePool(params, cfg, ctx, len(WHISPER_PROMPTS), cache_len,
                          ENCDEC_PAGE)
    rps = []
    for c, S in zip(caches, WHISPER_PROMPTS):
        rp = pool.ops.new_request()
        pool.install(rp, c, S)
        rps.append(rp)
    pos = np.asarray(WHISPER_PROMPTS, np.int64)
    toks = np.asarray(graph["tokens"])
    rows = 0
    for i in range(ENCDEC_GEN):
        if i == 1:                       # the waves after the capture
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for rp, p in zip(rps, pos):
            pool.prepare_decode_write(rp, int(p))
        got = pool.decode_wave(params, rps, pos, toks[:, i:i + 1])
        if not torch.equal(got, graph["logits"][i]):
            raise SystemExit(f"Whisper-small from pages: wave {i}'s logits differ "
                             f"from the slot map's")
        rows += got.shape[0]
        pos = pos + 1
    torch.cuda.synchronize()
    paged_ms = 1e3 * (time.perf_counter() - t0) / (ENCDEC_GEN - 1)
    kv_pool = sum(t.numel() * t.element_size() for p in pool.pools
                  for n, t in p.items() if n in ("k", "v"))
    cross_pool = sum(t.numel() * t.element_size() for p in pool.pools
                     for n, t in p.items() if n in CROSS)
    for rp in rps:
        pool.release(rp)
    pool.alloc.audit()
    print(f"{card}: Whisper-small from {ENCDEC_PAGE}-token pages: all {rows} logits rows "
          f"bit-equal to the slot map's; {paged_ms:.3f} ms a warm wave (slot map's warm "
          f"graph {graph['ms']:.3f}); modeled (bf16) state block "
          f"{pool.layout.state_bytes(2) / 1e6:.3f} MB a request (its cross K/V) beside "
          f"{pool.layout.page_bytes(pool.groups[0], ENCDEC_PAGE, 2) / 1e3:.1f} KB a K/V "
          f"page; on the card the fp32 cross K/V pools {cross_pool / 1e6:.1f} MB beside "
          f"{kv_pool / 1e6:.1f} MB of K/V page pools", flush=True)
    del pool, params, cache, caches, graph
    _release()

    # (b) InternVL2-76B's backbone, 8 of 80 layers: 4 requests of 256 patch
    # embeddings ahead of a 32-token prompt, prefilled together
    cfg = dataclasses.replace(get_config("internvl2-76b"), num_layers=VLM_LAYERS)
    params = transformer.init_params(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    n = cfg.num_patch_tokens
    cache_len = n + VLM_PROMPT + ENCDEC_GEN
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, VLM_PROMPT)),
                                       device=dev),
             "patches": torch.as_tensor(rng.standard_normal(
                 (4, n, cfg.d_model)).astype(np.float32), device=dev)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = engine.prefill(params, cfg, ctx, batch, cache_len)
    cache, first = engine.clone_cache(cache), logits.clone()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    if not bool(torch.isfinite(first).all()) or cache["pos"].tolist() != [n + VLM_PROMPT] * 4:
        raise SystemExit("InternVL2-76B: non-finite prefill logits, or the cache does "
                         "not count the patch positions")
    weights = _param_bytes(params)
    modeled = mm.decode_cache_bytes(cfg, cache_len, 4) * 4
    print(f"{card}: InternVL2-76B, {VLM_LAYERS} of 80 layers: {weights / 1e9:.3f} GB of "
          f"bf16 weights (memory model {mm.serve_weight_bytes(cfg) / 1e9:.3f} GB), the "
          f"embedding and head {2 * cfg.padded_vocab * cfg.d_model * 2 / 1e9:.3f} GB; a "
          f"batched prefill of 4 x ({n} patches + {VLM_PROMPT} tokens) {prefill_s:.2f} s "
          f"cold; cache positions {cache['pos'].tolist()}", flush=True)
    _encdec_turns("InternVL2-76B", card, params, cfg, ctx, cache, first,
                  weights + modeled)
    del params, cache
    _release()
    print(f"{card}: serve (enc-dec + VLM) phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def _digest(params) -> list:
    """A few values of every parameter, on the host: what a step changes."""
    from repro_torch.optim.adamw import param_list
    return [p.detach().reshape(-1)[:64].float().cpu() for p in param_list(params)]


def families_phase(card: str) -> tuple:
    """A few training steps of each family at full width through Trainer, as
    launch/train.py builds it: finite losses and grad norms, parameters
    changed, warm step seconds, tokens/s, the peak against the memory
    model.  Returns the fused leg's launches (Llama-4-Scout's MoE layer) and
    the tokens of its last step's FCDA chunk."""
    phase("train (families)")
    import dataclasses
    import gc
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import memory_model as mm
    from repro_torch.core.moe import DistContext
    from repro_torch.kernels import dispatch_cuda as dc
    from repro_torch.kernels.fused_moe import fused_moe
    from repro_torch.kernels.ragged_mlp import ragged_matmul
    from repro_torch.kernels.weight_grad import segment_outer
    from repro_torch.optim.adamw import named_params, param_list
    from repro_torch.training.step import init_train_state
    from repro_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counters = (dc.scatter_rows, dc.gather_combine, ragged_matmul, fused_moe,
                segment_outer)
    launches = dict.fromkeys((fn.__name__ for fn in counters), 0)
    for label, arch, layers, seq, batch, fused in FAMILY_RUNS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        ctx = DistContext(device=dev, moe_strategy="ep_shardmap" if fused else "auto",
                          moe_fused=fused)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, ctx, seq_len=seq, global_batch=batch, lr=1e-3, seed=0,
                          dtype=torch.bfloat16)
        state = init_train_state(cfg, torch.bfloat16, dev, 0)
        before = _digest(state.params)
        for fn in counters:
            fn.launches = 0
        state = trainer.fit(FAMILY_STEPS, state)
        torch.cuda.synchronize()
        got = {fn.__name__: fn.launches for fn in counters}
        wall = time.perf_counter() - t0
        after = _digest(state.params)
        names = [n for n, _ in named_params(state.params)]
        same = [n for n, a, b in zip(names, before, after) if torch.equal(a, b)]
        changed = len(before) - len(same)
        n_params = sum(p.numel() for p in param_list(state.params))
        static = mm.static_bytes(cfg, trainer.par)
        model = f"the memory model's static {static / 1e9:.2f} GB (12 B/param)"
        if fused:
            last = trainer.log[-1]
            rep = trainer.mact.memory_report(trainer.mact.history[-1]["s_pp"],
                                             last["chunks"], last["pipeline"])
            model = (f"MACT's static {rep['static_gb'] * 2**30 / 1e9:.2f} GB + "
                     f"activations {rep['activation_gb'] * 2**30 / 1e9:.2f} GB")
        for r in trainer.log:
            print(f"{card}: {label} step {r['step']}: loss {r['loss']:.6f}, grad_norm "
                  f"{r['grad_norm']:.4f}, schedule ({r['chunks']}, {r['pipeline']}), "
                  f"{r['time_s']:.3f} s, {r['tgs']:.1f} tokens/s", flush=True)
        warm = trainer.log[1:]
        print(f"{card}: {label} ({cfg.num_layers} layers, {n_params / 1e9:.3f} B "
              f"parameters, {batch} x {seq}): warm step {min(r['time_s'] for r in warm):.3f}"
              f"-{max(r['time_s'] for r in warm):.3f} s, {max(r['tgs'] for r in warm):.1f} "
              f"tokens/s; {changed} of {len(before)} parameters changed (a digest of "
              f"their first 64 values; not: {same}); "
              f"max_memory_allocated {(trainer.max_memory_allocated or 0) / 1e9:.2f} GB "
              f"against {model}; {wall:.1f} s with the weights' build"
              + (f"; launches {got}" if fused else ""), flush=True)
        bad = [r for r in trainer.log
               if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
        if bad or len(trainer.log) != FAMILY_STEPS or changed == 0:
            raise SystemExit(f"{label}: non-finite losses or grad norms, or no "
                             f"parameter changed: {bad}")
        if fused and not all(got.values()):
            raise SystemExit(f"{label}: a kernel of the fused leg never launched: {got}")
        if fused:
            t_chunk = seq * batch // trainer.log[-1]["chunks"]
        for k, v in got.items():
            launches[k] += v
        del trainer, state, before, after
        gc.collect()
    torch.cuda.empty_cache()
    print(f"{card}: train (families) phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, t_chunk


def _check_families() -> None:
    """The reduced Whisper-small and InternVL2-76B in fp32, the card against
    the CPU: prefill logits and greedy streams; then one training step of
    every reduced config of the registry (the EP fused leg where it has MoE
    layers), the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, registry
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    from repro_torch.training.step import make_train_state
    from repro_torch.training.trainer import Trainer

    for arch in ("whisper-small", "internvl2-76b"):
        cfg = get_config(arch).reduced()
        cpu = transformer.init_params(cfg, device="cpu", seed=1)
        rng = np.random.default_rng(3)
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 24)))}
        if cfg.encoder_layers:
            batch["frames"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        if cfg.num_patch_tokens:
            batch["patches"] = torch.as_tensor(rng.standard_normal(
                (2, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32))
        cache_len = 24 + cfg.num_patch_tokens + 12
        outs = {}
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            ctx = DistContext(device=torch.device(dev))
            b = _to(batch, dev)
            logits, _ = engine.prefill(params, cfg, ctx, b, cache_len)
            outs[dev] = (logits.cpu().clone(),
                         engine.generate(params, cfg, ctx, b, 12, cache_len).tolist())
        err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
        same = outs["cpu"][1] == outs["cuda"][1]
        print(f"reduced {cfg.name} fp32: prefill logits max |card - cpu| = {err:.3e}; "
              f"greedy streams of 2 requests {'equal' if same else 'DIFFER'}", flush=True)
        if not np.isfinite(err) or err > 1e-3 or not same:
            raise SystemExit(f"the card disagrees with the CPU on the reduced {arch}")
        engine.clear_step_cache()

    worst = 0.0
    for arch in sorted(registry()):
        cfg = get_config(arch).reduced()
        fused = transformer.num_moe_layers(cfg) > 0
        runs = {}
        for dev in ("cpu", "cuda"):
            # the same weights on each device, made anew: a step updates them in place
            params = transformer.init_params(cfg, device="cpu", seed=2)
            ctx = DistContext(device=torch.device(dev), moe_fused=fused,
                              moe_strategy="ep_shardmap" if fused else "auto")
            trainer = Trainer(cfg, ctx, seq_len=64, global_batch=2, lr=1e-3)
            trainer.fit(1, make_train_state(_to(params, dev)))
            runs[dev] = trainer.log[0]
        d = {k: abs(runs["cpu"][k] - runs["cuda"][k]) for k in ("loss", "grad_norm")}
        worst = max(worst, *d.values())
        print(f"reduced {cfg.name} fp32, 1 training step{' on the fused leg' if fused else ''}: "
              f"loss card {runs["cuda"]['loss']:.6f} cpu {runs['cpu']['loss']:.6f}, grad "
              f"norm card {runs["cuda"]['grad_norm']:.6f} cpu {runs['cpu']['grad_norm']:.6f}",
              flush=True)
        if not all(v <= 1e-4 for v in d.values()) or (
                runs["cpu"]["chunks"], runs["cpu"]["pipeline"]) != (
                runs["cuda"]["chunks"], runs["cuda"]["pipeline"]):
            raise SystemExit(f"the card disagrees with the CPU on a training step of the "
                             f"reduced {arch} (tolerance 1e-4)")
    print(f"every reduced config of the registry: one training step, card against CPU, "
          f"max |loss or grad norm difference| {worst:.3e} (tolerance 1e-4)", flush=True)


def check_phase() -> None:
    """The reduced config in fp32: the card (kernels) against the CPU (plain
    versions), same weights, same requests."""
    phase("check")
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, ServeConfig)

    # fp32 on the card as on the CPU: no TF32 in matmuls or convolutions,
    # whatever an earlier phase set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mixtral-8x7b").reduced()
    cpu = transformer.init_params(cfg, device="cpu", seed=1)
    gpu = {"embed": cpu["embed"].cuda(), "head": cpu["head"].cuda(),
           "final_norm": {"scale": cpu["final_norm"]["scale"].cuda()},
           "layers": [_to(layer, "cuda") for layer in cpu["layers"]]}
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 48))
    outs = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        ctx = DistContext(device=torch.device(dev))
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, ctx, {"tokens": torch.as_tensor(tokens, device=dev)})
        reqs = [Request(rid=i, tokens=rng_tokens, max_new_tokens=12)
                for i, rng_tokens in enumerate(
                    np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 32)))]
        sched = ContinuousBatchingScheduler(
            params, cfg, ctx, ServeConfig(max_slots=2, cache_len=80, prefill_chunk=16))
        sched.run(reqs)
        outs[dev] = (logits.cpu(), [r.out for r in reqs])
    err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
    same = outs["cpu"][1] == outs["cuda"][1]
    print(f"reduced {cfg.name} fp32: prefill logits max |card - cpu| = {err:.3e}; "
          f"greedy streams of 4 requests {'equal' if same else 'DIFFER'}", flush=True)
    if not np.isfinite(err) or err > 1e-3 or not same:
        raise SystemExit("the card disagrees with the CPU on the reduced config")

    for arch in ("jamba-1.5-large-398b", "mamba2-130m"):
        _check_state_model(arch)
    _check_families()

    # two training steps from the same weights on each training leg: the
    # card's kernels against the CPU's plain versions
    from repro_torch.training.step import make_train_state
    from repro_torch.training.trainer import Trainer
    for leg in ("fused", "ragged"):
        runs = {}
        for dev in ("cpu", "cuda"):
            ctx = DistContext(device=torch.device(dev), moe_strategy="ep_shardmap",
                              moe_fused=leg == "fused", moe_ragged=leg == "ragged")
            params = transformer.init_params(cfg, device="cpu", seed=2)
            trainer = Trainer(cfg, ctx, seq_len=128, global_batch=2, lr=1e-3)
            trainer.fit(2, make_train_state(_to(params, dev)))
            runs[dev] = trainer
        losses = {d: [r["loss"] for r in t.log] for d, t in runs.items()}
        dloss = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        same_sched = (runs["cpu"].chunk_trace == runs["cuda"].chunk_trace
                      and runs["cpu"].pipeline_trace == runs["cuda"].pipeline_trace)
        print(f"reduced {cfg.name} fp32, 2 training steps on the {leg} leg: losses "
              f"card {losses['cuda']} cpu {losses['cpu']}, max |card - cpu| = "
              f"{dloss:.3e}; chunk traces {runs['cuda'].chunk_trace} / "
              f"{runs['cpu'].chunk_trace}, pipeline traces "
              f"{runs['cuda'].pipeline_trace} / {runs['cpu'].pipeline_trace}", flush=True)
        tol = 1e-4 if leg == "fused" else 1e-5
        if not same_sched or not dloss <= tol:
            raise SystemExit(f"the card disagrees with the CPU on the reduced training "
                             f"run of the {leg} leg (tolerance {tol})")

    _check_selective(cfg)

    # the same on a 2x2 mesh: 4 gloo ranks on the card against 4 on the CPU
    import tempfile
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            _run_ranks(_check_rank, 4, (f"file://{tmp}/store-{dev}", dev, tmp), 300)
            runs[dev] = [json.loads(Path(tmp, f"{dev}{r}.json").read_text())
                         for r in range(4)]
    for leg in ("fused", "ragged", "placed"):
        got = {dev: [rec[leg] for rec in recs] for dev, recs in runs.items()}
        losses = {dev: recs[0]["losses"] for dev, recs in got.items()}
        dloss = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        traces = {(tuple(r["chunks"]), tuple(r["pipeline"]))
                  for recs in got.values() for r in recs}
        same_ranks = all(r["losses"] == recs[0]["losses"] for recs in got.values()
                         for r in recs)
        print(f"reduced {cfg.name} fp32 on a 2x2 mesh, 2 training steps on the {leg} leg: "
              f"losses card {losses['cuda']} cpu {losses['cpu']}, max |card - cpu| = "
              f"{dloss:.3e}; schedules {sorted(traces)}; equal on every rank: "
              f"{same_ranks}", flush=True)
        tol = 1e-5 if leg == "ragged" else 1e-4
        plans = {json.dumps([r["schedules"], r["placements"]])
                 for recs in got.values() for r in recs}
        if leg == "placed":
            first = got["cuda"][0]
            print(f"  placed: layer 0's router zeroed (every token on experts 0 and 1), "
                  f"adaptive MACT, a replica slot per rank: schedule vectors "
                  f"{first['schedules']}, placements {first['placements']}; equal on every "
                  f"rank of both meshes: {len(plans) == 1}", flush=True)
            moved = first["placements"][-1][0] != list(range(cfg.moe.num_experts))
            if len(plans) != 1 or not moved:
                raise SystemExit("the 2x2 mesh's placed run: the card's schedules or "
                                 "placements differ from the CPU's, or layer 0 did not move")
        if len(traces) != 1 or not same_ranks or not dloss <= tol:
            raise SystemExit(f"the 2x2 mesh's reduced training run of the {leg} leg: the "
                             f"card disagrees with the CPU (tolerance {tol}), or the "
                             f"ranks disagree")


def _check_selective(cfg) -> None:
    """Two reduced fp32 training steps under ``remat_policy="selective"`` on
    the ragged leg, the card against the CPU from the same weights: losses
    and grad norms within 1e-5, and on each device the attention's q, k and
    v projections computed once a step (the backward recomputes the rest of
    each layer from the saved projections).  Then, on the card, one forward
    and backward of a batch under "none", "selective" and "full": the bytes
    the forward leaves held for the backward must fall in that order, since
    "selective" keeps q, k and v beside the layer's input and "none" keeps
    every activation; the peaks are printed beside them."""
    import dataclasses

    import torch
    from repro_torch.core.moe import DistContext
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import blocks, transformer
    from repro_torch.optim.adamw import named_params
    from repro_torch.training.step import loss_fn, make_train_state
    from repro_torch.training.trainer import Trainer

    cfg = dataclasses.replace(cfg, remat_policy="selective")
    n_attn = sum(spec.mixer == "attn" for spec in cfg.layer_specs())
    runs = {}
    for dev in ("cpu", "cuda"):
        ctx = DistContext(device=torch.device(dev), moe_strategy="ep_shardmap",
                          moe_ragged=True)
        params = transformer.init_params(cfg, device="cpu", seed=2)
        trainer = Trainer(cfg, ctx, seq_len=128, global_batch=2, lr=1e-3)
        blocks.qkv_proj.runs = 0
        trainer.fit(2, make_train_state(_to(params, dev)))
        runs[dev] = ([(r["loss"], r["grad_norm"]) for r in trainer.log], blocks.qkv_proj.runs)
    diff = max(abs(a - b) for x, y in zip(runs["cpu"][0], runs["cuda"][0])
               for a, b in zip(x, y))
    print(f"reduced {cfg.name} fp32, 2 training steps on the ragged leg under selective "
          f"remat: (loss, grad norm) card {runs['cuda'][0]} cpu {runs['cpu'][0]}, max "
          f"|card - cpu| = {diff:.3e}; q, k, v projections computed card "
          f"{runs['cuda'][1]} / cpu {runs['cpu'][1]} times ({n_attn} attention layers, "
          f"2 steps)", flush=True)
    if not diff <= 1e-5 or {runs[d][1] for d in runs} != {2 * 3 * n_attn}:
        raise SystemExit("selective remat: the card disagrees with the CPU (tolerance "
                         "1e-5), or a step recomputed the q, k, v projections")

    dev = torch.device("cuda")
    ctx = DistContext(device=dev, moe_strategy="ep_shardmap", moe_ragged=True)
    params = _to(transformer.init_params(cfg, device="cpu", seed=2), dev)
    leaves = [p.requires_grad_() for _, p in named_params(params)]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLMData(cfg, 1024, 2, seed=1).batch_at(0).items()}
    mem = {}
    for policy in ("none", "selective", "full"):
        pcfg = dataclasses.replace(cfg, remat_policy=policy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loss_fn(params, pcfg, ctx, batch)
        held = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        mem[policy] = (held, torch.cuda.max_memory_allocated() - base)
        del loss, grads
    print(f"reduced {cfg.name} fp32, one forward and backward of 2 x 1024 tokens on the "
          f"ragged leg: bytes held for the backward / forward + backward peak above the "
          f"weights: " + ", ".join(f"{p} {h} / {k}" for p, (h, k) in mem.items()),
          flush=True)
    if not mem["none"][0] > mem["selective"][0] > mem["full"][0]:
        raise SystemExit("selective remat: the forward did not hold fewer bytes than "
                         "'none' and more than 'full'")


def _check_state_model(arch: str) -> None:
    """A reduced state-carrying config in fp32, the card against the CPU:
    prefill logits and the scheduler's greedy streams; for Jamba also, on
    the card, 2 of its 4 experts resident with the prefetch off, so decode
    waves miss, re-run from the members' states put back, and must give the
    default run's streams."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, ServeConfig)

    cfg = get_config(arch).reduced()
    cpu = transformer.init_params(cfg, device="cpu", seed=1)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 48))

    def serve(params, dev, hook=None, **kw):
        reqs = [Request(rid=i, tokens=t, max_new_tokens=12) for i, t in enumerate(
            np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 32)))]
        sched = ContinuousBatchingScheduler(
            params, cfg, DistContext(device=torch.device(dev)),
            ServeConfig(max_slots=2, cache_len=80, prefill_chunk=16, **kw))
        if hook is not None:
            hook(sched)
        try:
            sched.run(reqs)
        finally:
            sched.close()
        return [r.out for r in reqs], sched

    outs = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        with torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, DistContext(device=torch.device(dev)),
                {"tokens": torch.as_tensor(tokens, device=dev)})
        outs[dev] = (logits.cpu(), serve(params, dev)[0])
    err = (outs["cpu"][0] - outs["cuda"][0]).abs().max().item()
    same = outs["cpu"][1] == outs["cuda"][1]
    print(f"reduced {cfg.name} fp32: prefill logits max |card - cpu| = {err:.3e}; "
          f"greedy streams of 4 requests {'equal' if same else 'DIFFER'}", flush=True)
    if not np.isfinite(err) or err > 1e-3 or not same:
        raise SystemExit(f"the card disagrees with the CPU on the reduced {arch}")
    if cfg.moe is None:
        return
    decode_reruns = []

    def no_prefetch(sched):
        sched.residency.prefetch = lambda p, predicted: None
        wave = sched._decode_wave_expert

        def counted(now):
            before = sched.demand_reruns
            wave(now)
            decode_reruns.append(sched.demand_reruns - before)
        sched._decode_wave_expert = counted
    got, sched = serve(_to(cpu, "cuda"), "cuda", hook=no_prefetch, wave_size=2,
                       resident_experts=2)
    print(f"reduced {cfg.name} fp32 on the card, 2 of {cfg.moe.num_experts} experts "
          f"resident, prefetch off: {sched.demand_reruns} demand re-runs "
          f"({sum(decode_reruns)} of decode waves); streams "
          f"{'equal' if got == outs['cuda'][1] else 'DIFFER from'} the default run's",
          flush=True)
    if got != outs["cuda"][1] or not sum(decode_reruns):
        raise SystemExit(f"the reduced {arch} under residency: decode waves must re-run "
                         f"and give the default run's streams")


def _check_rank(rank: int, store: str, device: str, out_dir: str) -> None:
    """One rank of check_phase's 2x2 mesh: 2 reduced fp32 training steps on
    each leg from the same weights as the one-peer check, and on the fused
    leg with adaptive MACT and expert placement (a replica slot per rank)
    on skewed routing, on ``device``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.training.step import make_train_state
    from repro_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = mesh_lib.init_world(rank, 4, store, device)
        mesh = mesh_lib.make_host_mesh((2, 2))
        cfg = get_config("mixtral-8x7b").reduced()
        rec = {}
        for leg in ("fused", "ragged", "placed"):
            ctx = DistContext(device=dev, moe_strategy="ep_shardmap", mesh=mesh,
                              moe_fused=leg != "ragged", moe_ragged=leg == "ragged")
            params = transformer.init_params(cfg, device="cpu", seed=2, mesh=mesh)
            planner = {}
            if leg == "placed":
                # a zero router ties every score: top-2 sends each token to
                # experts 0 and 1, which identity places on one rank
                params["layers"][0]["ffn"]["router"]["w"].zero_()
                planner = dict(adaptive_mact=True, use_placement=True,
                               placement_replicas=1)
            trainer = Trainer(cfg, ctx, seq_len=128, global_batch=4, lr=1e-3, **planner)
            trainer.fit(2, make_train_state(_to(params, dev)))
            rec[leg] = {"losses": [r["loss"] for r in trainer.log],
                        "chunks": trainer.chunk_trace, "pipeline": trainer.pipeline_trace,
                        "schedules": [[list(s) for s in v] for v in trainer.schedule_trace],
                        "placements": [r["placements"] for r in trainer.placement_trace]}
        Path(out_dir, f"{device}{rank}.json").write_text(json.dumps(rec))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import shutil
    import tempfile

    from repro_torch.kernels import autotune
    # the tile cache of this run: empty, so every phase runs the default
    # tiles whatever a cache under $HOME holds (spawned ranks inherit it)
    tile_dir = tempfile.mkdtemp(prefix="chip-smoke-tiles-")
    autotune.set_cache_path(os.path.join(tile_dir, "autotune.json"))
    try:
        return run_phases()
    finally:
        shutil.rmtree(tile_dir, ignore_errors=True)


def run_phases() -> int:
    import torch
    card = device_phase()
    build_phase()
    entries = kernels_phase()
    entries.update(train_kernels_phase())
    entries.update(attention_kernels_phase())
    # each path's launches, its counts set to 0 just before it and read just after
    launches, served = serve_phase()
    paths = {"serve": launches}
    profile_phase(served)
    paths["serve (paged)"] = paged_phase(served, card)
    paths["serve (expert-aware)"] = expert_phase(served, card)
    del served
    paths["serve (hybrid)"] = hybrid_phase(card)
    encdec_phase(card)
    paths["train (fused leg)"], ce = train_phase()
    paths["train (ragged leg)"] = train_ragged_phase()
    paths["train (EP, 2 ranks)"] = train_ep_phase(ce)
    paths["train (adaptive + placement, 2 ranks)"] = train_adaptive_phase()
    paths["train (resilience)"] = train_resilience_phase()
    paths["train (families)"], scout_chunk = families_phase(card)
    scout_kernels(entries, scout_chunk)
    check_phase()
    for path, launches in paths.items():
        for name, n in launches.items():
            entries[name]["launches"] += n
            entries[name].setdefault("launches_by_path", {})[path] = n
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
