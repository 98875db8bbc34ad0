"""Training launcher.

  # full-width Mixtral-8x7B cut to 2 layers, bf16, EP at one peer, the fused
  # expert leg, MACT choosing the FCDA schedule, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --layers 2 --ep --fused --steps 4 --seq-len 2048 --global-batch 2
  # the reduced config on the CPU (plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --smoke --device cpu --ep --fused --steps 3

Training on the card runs the EP strategy with the fused expert leg
(``--ep --fused``).  The EP strategy's ragged leg trains too, through
``Trainer`` with ``DistContext(moe_strategy="ep_shardmap", moe_ragged=True)``;
the JAX launcher has no flag for it, and neither has this one.  The local
path and the EP capacity layout run the grouped kernels, which have no
backward: on the card, training on them raises, as training them through
Pallas raises in the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config (2 layers, small dims)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers, every width kept "
                         "(0 = the config's own depth)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="parameter type (default: bfloat16 on the card, "
                         "float32 on the CPU); AdamW moments are fp32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=1,
                    help="FCDA chunk count with --no-mact")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="max FCDA schedule depth MACT may pick on the EP path; "
                         "with --no-mact, the fixed depth to run")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="force the sequential FCDA chunk loop")
    ap.add_argument("--no-mact", action="store_true")
    ap.add_argument("--remat", default=None, choices=["none", "full", "memfine"])
    ap.add_argument("--ep", action="store_true",
                    help="the EP strategy at one peer (the path that trains)")
    ap.add_argument("--fused", action="store_true",
                    help="the fused expert leg over the ragged layout "
                         "(kernels/fused_moe.py); MACT plans with the reduced "
                         "Eq. 2 term; needs --ep")
    ap.add_argument("--log-json", default=None)
    args = ap.parse_args(argv)
    if args.fused and not args.ep:
        ap.error("--fused needs --ep (the fused leg is the EP strategy's)")
    return args


def main(argv=None):
    """Parse ``argv`` and train; returns (trainer, final state) to an
    in-process caller."""
    args = parse_args(argv)
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    dtype = args.dtype or ("bfloat16" if device.type == "cuda" else "float32")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat_policy=args.remat)
    if device.type == "cuda" and not args.fused:
        raise RuntimeError(
            "training without --fused runs the grouped expert kernels, which "
            "have no backward; pass --ep --fused to train on the card (the "
            "ragged leg, DistContext(moe_strategy='ep_shardmap', "
            "moe_ragged=True), trains through Trainer)")
    depth = 1 if args.no_pipeline else args.pipeline_depth
    ctx = DistContext(device=device, moe_chunks=args.chunks,
                      pipeline_chunks=depth if args.no_mact else 1,
                      moe_strategy="ep_shardmap" if args.ep else "auto",
                      moe_fused=args.fused)
    trainer = Trainer(cfg, ctx, seq_len=args.seq_len,
                      global_batch=args.global_batch, lr=args.lr, seed=args.seed,
                      dtype=getattr(torch, dtype), use_mact=not args.no_mact,
                      max_pipeline_depth=depth)
    print(f"training {cfg.name} ({cfg.num_layers} layers, {dtype}, {device}): "
          f"seq {args.seq_len} x batch {args.global_batch}, "
          f"{'EP at one peer' if args.ep else 'local path'}"
          f"{', fused expert leg' if args.fused else ''}, "
          f"MACT {'off' if args.no_mact else 'on'}", flush=True)
    state = trainer.fit(args.steps, verbose=True)
    if trainer.log:
        print(f"final loss {trainer.log[-1]['loss']:.4f} at step "
              f"{trainer.log[-1]['step']}; chunk trace {trainer.chunk_trace[-8:]}; "
              f"pipeline trace {trainer.pipeline_trace[-8:]}")
    if device.type == "cuda":
        print(f"peak device memory (max_memory_allocated) "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB on "
              f"{torch.cuda.get_device_name(device)}")
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(trainer.log, f, indent=1)
    return trainer, state


if __name__ == "__main__":
    main()
