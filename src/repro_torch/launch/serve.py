"""Serving launcher: continuous batching over a synthetic Poisson trace.

Requests arrive as a Poisson process with per-request prompt and generation
lengths; the continuous-batching scheduler admits them against the serving
memory model, interleaves chunked prefill with decode waves, and the run
reports aggregate tok/s, p50/p99 request latency and the modeled peak
against the budget.  Weights are random, from a seeded generator.

On the card each decode wave and prefill chunk replays a CUDA graph of the
engine's compiled step (``serving/engine.py``), captured at its first call
for each shape; the summary says how many graphs were captured and how long
the captures took.  ``--eager`` runs the same steps eagerly instead, the
counterpart of ``jax.disable_jit``, for comparisons.

  # full-width Mixtral-8x7B cut to 4 layers, bf16, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --layers 4
  # the same, every step eager (no CUDA graphs)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --layers 4 --eager
  # the reduced config on the CPU (plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses


def make_trace(rng, n: int, rate_hz: float, prompt_lens, gen_range,
               vocab: int, chunk: int):
    """n Poisson arrivals; prompt lengths drawn from ``prompt_lens``
    (multiples of the prefill chunk)."""
    import numpy as np

    from repro_torch.serving.scheduler import Request

    for S in prompt_lens:
        if S % chunk and S > chunk:
            raise ValueError(f"--prompt-lens entry {S} is not a multiple of "
                             f"--prefill-chunk {chunk}")
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate_hz) if rate_hz > 0 else 0.0
        S = int(rng.choice(prompt_lens))
        out.append(Request(
            rid=i,
            tokens=rng.integers(0, vocab, S).astype(np.int32),
            max_new_tokens=int(rng.integers(gen_range[0], gen_range[1] + 1)),
            arrival=t))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (2 layers, small dims)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, every width kept "
                         "(0 = the config's own depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="weight type (default: bfloat16 on the card, "
                         "float32 on the CPU)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="Poisson arrival rate (requests/s); 0 = all at t=0")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=0,
                    help="per-request cache length (0 = max prompt + gen)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--prompt-lens", default="16,32,48,64",
                    help="comma list of prompt lengths to draw from")
    ap.add_argument("--gen", default="4,24", help="min,max generated tokens")
    ap.add_argument("--budget-gb", type=float, default=0.0,
                    help="override the hardware memory budget (GB)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="admission deadline: a request not admitted within "
                         "this many seconds of arrival is shed with a "
                         "retry-after quote")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="overload bound on the WAITING queue (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eager", action="store_true",
                    help="run every step eagerly, no CUDA graphs (the "
                         "counterpart of jax.disable_jit)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace, params: dict | None = None):
    """Weights on the device, the scheduler and the request trace; returns
    (scheduler, trace).  ``params``: weights that ``args`` already built,
    reused instead of building them again."""
    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import H100_80G, get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.models import transformer
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               ServeConfig)

    device = resolve_device(args.device)
    dtype = args.dtype or ("bfloat16" if device.type == "cuda" else "float32")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    ctx = DistContext(device=device)
    if params is None:
        params = transformer.init_params(cfg, device=device,
                                         dtype=getattr(torch, dtype),
                                         seed=args.seed)

    rng = np.random.default_rng(args.seed)
    prompt_lens = [int(s) for s in args.prompt_lens.split(",")]
    gen_lo, gen_hi = (int(s) for s in args.gen.split(","))
    trace = make_trace(rng, args.requests, args.arrival_rate, prompt_lens,
                       (gen_lo, gen_hi), cfg.vocab_size, args.prefill_chunk)

    cache_len = args.cache_len or max(prompt_lens) + gen_hi
    hw = H100_80G
    if args.budget_gb:
        # the flag names the admission budget itself, so alpha must not
        # discount it a second time
        hw = dataclasses.replace(hw, hbm_bytes=args.budget_gb * 1e9, alpha=1.0)
    scfg = ServeConfig(max_slots=args.max_slots, cache_len=cache_len,
                       prefill_chunk=args.prefill_chunk, hw=hw,
                       temperature=args.temperature, seed=args.seed,
                       deadline_s=args.deadline_s,
                       max_waiting=args.max_waiting)
    print(f"serving {cfg.name} ({cfg.num_layers} layers, {dtype}, "
          f"{device}): {args.requests} requests, rate={args.arrival_rate}/s, "
          f"slots={args.max_slots}, cache_len={cache_len}, "
          f"prefill_chunk={args.prefill_chunk}, slot-map, "
          f"{'eager' if args.eager else 'compiled'} steps")
    return ContinuousBatchingScheduler(params, cfg, ctx, scfg,
                                       eager=args.eager), trace


def main(argv=None):
    """Parse ``argv``, serve the trace, print the summary; returns
    (scheduler, metrics) to an in-process caller."""
    from repro_torch.serving import engine

    args = parse_args(argv)
    sched, trace = setup(args)
    before = engine.step_cache_info()
    m = sched.run(trace)
    after = engine.step_cache_info()
    gen_lo, gen_hi = (int(s) for s in args.gen.split(","))

    budget_gb = m["budget_bytes"] / 1e9
    peak_gb = m["modeled_peak_bytes"] / 1e9
    print(f"served {m['requests']} requests, {m['generated_tokens']} tokens "
          f"in {m['elapsed_s']:.2f}s -> {m['tok_per_s']:.1f} tok/s")
    print(f"latency p50={m['latency_p50_s']:.2f}s p99={m['latency_p99_s']:.2f}s "
          f"(gen {gen_lo}-{gen_hi} tokens/request)")
    print(f"memory: modeled peak {peak_gb:.2f} GB <= budget {budget_gb:.2f} GB "
          f"(headroom {budget_gb - peak_gb:.2f} GB), "
          f"max occupancy {m['max_occupancy']}/{args.max_slots} slots")
    print(f"schedule: {m['decode_waves']} decode waves, "
          f"{m['prefill_chunks']} interleaved prefill chunks")
    if args.eager or sched.ctx.device.type != "cuda":
        print("steps: eager, no CUDA graphs")
    else:
        print(f"steps: {after['captures'] - before['captures']} CUDA graphs "
              f"captured in {after['capture_s'] - before['capture_s']:.3f} s "
              f"(each at its first call, inside the serving time above)")
    if m["shed"] or m["faults"]:
        print(f"resilience: {m['shed']} shed "
              f"(retry-after p50 {m['retry_after_p50_s']:.1f}s), "
              f"{m['faults']} faulted waves, {m['requeues']} requeues, "
              f"0 accepted requests lost")
    if sched.finished:
        sample = sched.finished[0]
        print(f"sample (rid {sample.rid}): {sample.out[:12]}")
    return sched, m


if __name__ == "__main__":
    main()
