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
              Mixtral-8x7B's heads), in fp32 and bf16, and timed beside the
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
              bit.
4. serve   -- repro_torch.launch.serve drives full-width Mixtral-8x7B (depth
              cut to 4 layers, random bf16 weights from a seed) through an
              8-request trace, every decode wave and prefill chunk a replay
              of a captured CUDA graph (serving/engine.py); every request
              must finish with finite logits, and each grouped kernel must
              have launched once per MoE layer per pass, replays counted.
5. profile -- the same trace on the same weights, eager and compiled in
              turns, three runs each, the compiled ones on warm graphs:
              streams, admission order and counts must equal the serve
              phase's.  Then one run each way under torch.profiler (device
              busy time, by kernel), each run's ms a pass, tok/s, p50/p99,
              device idle share, peak memory against the modeled peak, and
              one decode wave both ways: logits bit for bit, device time.
6. train   -- repro_torch.launch.train trains full-width Mixtral-8x7B (depth
              cut to 2 layers, bf16 weights, fp32 AdamW moments) for 4 steps
              of 2 x 2048 tokens on the EP strategy at one peer with the
              fused expert leg, MACT choosing the schedule; every loss and
              grad norm must be finite and every kernel of the path must
              have launched.  Then one more step under torch.profiler, and
              the peak of one forward + backward against MACT's modeled
              activation bytes at MACT's schedule, at (2, 1) and unchunked:
              two sequential chunks must not raise it above one chunk's.
7. train (ragged leg) -- the same model and steps through Trainer, built as
              launch/train.py builds it, on the three-launch ragged leg
              (dispatch buffer, ragged_swiglu, ragged_matmul, combine);
              fused_moe must not launch.  The same profile and peaks (Eq. 2
              with the dispatch buffer's term).
8. train (EP, 2 ranks) -- launch/train.py --mesh 1x2 as 2 ranks on the one
              card over gloo (started as torchrun starts them): the same
              model, batch and steps, each rank holding 4 of the 8 experts
              of each layer and one of the two sequences, on the fused leg,
              then the ragged leg through Trainer.  Each rank reports its
              log, schedules, peak against MACT's per-rank model, forward +
              backward peaks, exchanges and their time on gloo, and kernel
              launches; the phase fails on a non-finite loss, ranks that
              disagree, a kernel of a leg that did not launch on a rank,
              (2, 1) above (1, 1), or a step-1 ce off the one-peer run's.
9. train (adaptive + placement, 2 ranks) -- the EP phase's model, mesh,
              batch and fused leg, 5 steps, layer 0's router zeroed after
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
10. train (resilience) -- full-width Mixtral-8x7B at 1 layer, bf16, fused
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
11. check  -- the reduced Mixtral config in fp32 on the card (TF32 off for
              matmuls and cuDNN) against the same weights on the CPU: prefill
              logits and greedy token streams must agree, and 2 training
              steps on each leg must give the same schedules and losses, at
              one peer and on a 2x2 mesh (4 gloo ranks on the card against
              4 on the CPU), where 2 fused-leg steps with adaptive MACT and
              expert placement (a replica slot per rank, layer 0's router
              zeroed) must also give the same schedule vectors and
              placements.

The next-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""

from __future__ import annotations

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


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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
    return entries


def _routed_chunk(gen, dev):
    """One FCDA chunk's routing at the training path's shapes, and the
    plans the EP leg derives from it: ids of top-2 distinct experts of 8."""
    import torch
    from repro_torch.core import dispatch as dsp
    scores = torch.rand((T_CHUNK, E), generator=gen, device=dev)
    ids = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :TOP_K]
    up = dsp.make_unified_plan(ids.to(torch.int32), E, 1, cap_send=T_CHUNK * TOP_K)
    rows = T_CHUNK * TOP_K
    R = -(-(rows + E * BLOCK_M) // BLOCK_M) * BLOCK_M
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


def _bound(nbytes: float, flops: float, rate: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    up, plan, R = _routed_chunk(gen, dev)
    rows = T_CHUNK * TOP_K
    live = int(plan.total_rows)                   # rows this run's data fills
    used = torch.unique(plan.block_to_expert[:live // BLOCK_M]).numel()
    send_pos = invert_slots(up.send_slots, rows)
    send_src = torch.where(send_pos >= 0, send_pos // TOP_K, -1).to(torch.int32)
    recv_pos = invert_slots(plan.slots, R)
    recv_src = torch.where(recv_pos >= 0, recv_pos, -1).to(torch.int32)
    weights = torch.rand((T_CHUNK, TOP_K), generator=gen, device=dev)
    weights = weights / weights.sum(-1, keepdim=True)
    # the combine backward's scatter: each ragged row a slot weight, rows
    # past the routed load and padding rows of a block dead
    wrow = torch.rand(R, generator=gen, device=dev)
    recv_read = int(((recv_src >= 0) & (torch.arange(R, device=dev) < live)).sum())

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    w1 = randn((E, D_MODEL, D_FF), D_MODEL ** -0.5)
    w3 = randn((E, D_MODEL, D_FF), D_MODEL ** -0.5)
    w2 = randn((E, D_FF, D_MODEL), D_FF ** -0.5)
    x_chunk = randn((T_CHUNK, D_MODEL))
    x_rows = randn((rows, D_MODEL))
    buf = ref.scatter_rows_ref(x_rows, recv_src, plan.total_rows)   # (R, d)
    h = randn((R, D_FF)) * (torch.arange(R, device=dev) < live)[:, None]
    b2e, total = plan.block_to_expert, plan.total_rows
    wslot = torch.ones(R, device=dev)
    el = 2                                     # bf16 bytes per element
    # the ragged layout as a grouped GEMM's group ends: each expert's live
    # rows lie in one run of row blocks, in ascending expert order
    live_b2e = b2e[:live // BLOCK_M].long()
    if not bool((live_b2e[1:] >= live_b2e[:-1]).all()):
        raise SystemExit("the ragged plan's row blocks are not in expert order")
    offs = (torch.bincount(live_b2e, minlength=E).cumsum(0) * BLOCK_M).to(torch.int32)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        print(f"torch {torch.__version__} has no torch._grouped_mm: ragged_matmul "
              f"has no one-call yardstick here", flush=True)

    # name -> list of shape cases; each case: (label, kernel fn, plain fn,
    # fp32 inputs, library fn or None, bytes, flops, tolerance fp32: 0 for
    # bit-equality in both dtypes)
    cases = {
        "scatter_rows": [
            (f"R={rows} T={T_CHUNK} d={D_MODEL}", dc.scatter_rows,
             ref.scatter_rows_ref, (x_chunk, send_src, rows),
             # every row of the send buffer is live here, so index_select of
             # the source rows is the same function on these inputs
             lambda x, src, _: torch.index_select(x, 0, src),
             # each of the T source rows read once, the R rows written, the
             # row map read
             el * (T_CHUNK + rows) * D_MODEL + 4 * rows, 0, 0.0),
            (f"R={R} T={rows} d={D_MODEL}, slot weights, {recv_read} rows live "
             f"(combine backward)", dc.scatter_rows, ref.scatter_rows_ref,
             (x_rows, recv_src, total, wrow),
             None,                 # no one PyTorch call writes the zeros and the scale
             # the live rows read, every row written, the row map and the
             # weights read; one multiply per live element
             el * (recv_read + R) * D_MODEL + (4 + el) * R, recv_read * D_MODEL, 0.0)],
        "gather_combine": [
            (f"T={T_CHUNK} K={TOP_K} d={D_MODEL} (EP combine)", dc.gather_combine,
             ref.gather_combine_ref,
             (x_rows, up.send_slots, weights),
             # every slot is live at one peer: a weighted sum bag of K rows
             lambda buf_, slots, w: F.embedding_bag(slots, buf_, mode="sum",
                                                    per_sample_weights=w),
             el * (T_CHUNK * TOP_K + T_CHUNK) * D_MODEL, 2 * T_CHUNK * TOP_K * D_MODEL,
             1e-6),
            (f"T={rows} K=1 d={D_MODEL} (fused backward dx)", dc.gather_combine,
             ref.gather_combine_ref, (buf, plan.slots),
             # every received row is live and K = 1: a row gather
             lambda buf_, slots: torch.index_select(buf_, 0, slots[:, 0]),
             el * 2 * rows * D_MODEL, 0, 0.0)],
        "ragged_matmul": [
            (f"({R}, {D_MODEL}) @ w1 ({D_MODEL}, {D_FF})", ragged_matmul,
             lambda a, w, *r: ref.ragged_matmul_ref(a, w, *r[:2]),
             (buf, w1, b2e, total, BLOCK_M),
             # the live rows as groups of a grouped GEMM (no rows past them)
             grouped_mm and (lambda a, w, *_: grouped_mm(a[:live], w, offs=offs)),
             el * (live * D_MODEL + used * D_MODEL * D_FF + R * D_FF),
             2 * live * D_MODEL * D_FF, 1e-4),
            (f"({R}, {D_FF}) @ w1^T ({D_FF}, {D_MODEL})",
             lambda a, w, *r: ragged_matmul(a, w, *r, transpose_w=True),
             lambda a, w, *r: ref.ragged_matmul_ref(a, w.transpose(1, 2), *r[:2]),
             (h, w1, b2e, total, BLOCK_M),
             grouped_mm and (lambda a, w, *_: grouped_mm(a[:live], w.transpose(1, 2),
                                                         offs=offs)),
             el * (live * D_FF + used * D_MODEL * D_FF + R * D_MODEL),
             2 * live * D_MODEL * D_FF, 1e-4),
            (f"({R}, {D_FF}) @ w2 ({D_FF}, {D_MODEL})", ragged_matmul,
             lambda a, w, *r: ref.ragged_matmul_ref(a, w, *r[:2]),
             (h, w2, b2e, total, BLOCK_M),
             grouped_mm and (lambda a, w, *_: grouped_mm(a[:live], w, offs=offs)),
             el * (live * D_FF + used * D_FF * D_MODEL + R * D_MODEL),
             2 * live * D_MODEL * D_FF, 1e-4)],
        "ragged_swiglu": [(
            f"({R}, {D_MODEL}) @ w1, w3 ({D_MODEL}, {D_FF})", ragged_swiglu,
            lambda a, u, v, *r: ref.ragged_swiglu_ref(a, u, v, *r[:2]),
            (buf, w1, w3, b2e, total, BLOCK_M),
            None,                      # no one PyTorch call computes it
            el * (live * D_MODEL + 2 * used * D_MODEL * D_FF + R * D_FF),
            2 * 2 * live * D_MODEL * D_FF, 1e-4)],
        "fused_moe": [(
            f"T={rows} R={R} bm={BLOCK_M} E={E} d={D_MODEL} f={D_FF}", fused_moe,
            lambda x, a, b, c, src, ws, tot, bb: ref.fused_moe_rows_ref(
                x, a, b, c, src, ws, bb, tot),
            (x_rows, w1, w3, w2, recv_src, wslot, total, b2e), None,
            el * (2 * rows * D_MODEL + 3 * used * D_MODEL * D_FF),
            3 * 2 * live * D_MODEL * D_FF, 1e-4)],
    }
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
    replaces = {"scatter_rows": "src/repro/kernels/dispatch_pallas.py:63",
                "gather_combine": "src/repro/kernels/dispatch_pallas.py:127",
                "ragged_matmul": "src/repro/kernels/ragged_mlp.py:99",
                "ragged_swiglu": "src/repro/kernels/ragged_mlp.py:131",
                "fused_moe": "src/repro/kernels/fused_moe.py:105"}
    sources = {"scatter_rows": "dispatch.cu", "gather_combine": "dispatch.cu",
               "ragged_matmul": "ragged_mlp.cu", "ragged_swiglu": "ragged_mlp.cu",
               "fused_moe": "fused_moe.cu"}
    print(f"chunk routing: {live} of {R} ragged rows live, {used} experts used",
          flush=True)
    entries = {}
    for name, shape_cases in cases.items():
        shapes = []
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
        head = shapes[0]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": 0,
            **{k: head[k] for k in ROW_KEYS},
            "shapes": shapes,
        }
    del w1, w3, w2, x_rows, x_chunk, wrow
    torch.cuda.empty_cache()
    entries["segment_outer"] = weight_grad_kernel(buf, h, b2e, total, live, offs, gen)
    del buf, h
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
    R = buf.shape[0]
    liverows = (torch.arange(R, device=dev) < live)[:, None]
    g_buf = torch.randn((R, D_MODEL), generator=gen, device=dev) * liverows
    grouped_mm = getattr(torch, "_grouped_mm", None)
    el = 2
    shapes = []
    # (label, a, b, out (E, K, N), accumulate)
    cases = [(tag + "dw1 = bufᵀ @ dh1, written", buf, h, (n_experts, D_MODEL, D_FF), False),
             (tag + "dw1 = bufᵀ @ dh1, added", buf, h, (n_experts, D_MODEL, D_FF), True),
             (tag + "dw2 = aᵀ @ g_buf, added", h, g_buf, (n_experts, D_FF, D_MODEL), True)]
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
    del trainer, state
    torch.cuda.empty_cache()
    return launches, ce


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
ADAPT_STEPS = 5
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
    return launches, served


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
    from torch.autograd import DeviceType
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
        rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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
    device_phase()
    build_phase()
    entries = kernels_phase()
    entries.update(train_kernels_phase())
    entries.update(attention_kernels_phase())
    # each path's launches, its counts set to 0 just before it and read just after
    launches, served = serve_phase()
    paths = {"serve": launches}
    profile_phase(served)
    del served
    paths["train (fused leg)"], ce = train_phase()
    paths["train (ragged leg)"] = train_ragged_phase()
    paths["train (EP, 2 ranks)"] = train_ep_phase(ce)
    paths["train (adaptive + placement, 2 ranks)"] = train_adaptive_phase()
    paths["train (resilience)"] = train_resilience_phase()
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
