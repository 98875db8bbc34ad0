"""Training launcher.

  # full-width Mixtral-8x7B cut to 2 layers, bf16, EP at one peer, the fused
  # expert leg, MACT choosing the FCDA schedule, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --layers 2 --ep --fused --steps 4 --seq-len 2048 --global-batch 2
  # the reduced config on the CPU (plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --smoke --device cpu --ep --fused --steps 3
  # EP across 2 ranks (each holds 4 of the 8 experts), spawned by the
  # launcher; under torchrun, drop --nproc and run
  #   torchrun --nproc-per-node 2 -m repro_torch.launch.train ... --mesh 1x2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --layers 2 --ep --fused --steps 4 --seq-len 2048 --global-batch 2 \
      --mesh 1x2 --nproc 2
  # adaptive per-layer MACT and expert placement with one replica slot per
  # rank, on 2 spawned CPU ranks
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --smoke --device cpu --ep --fused --mesh 1x2 --nproc 2 \
      --adaptive-mact --placement --placement-replicas 1 --steps 4
  # resilience: an injected OOM walks the degradation ladder, checkpoints
  # every 2 steps; after a crash, --resume continues to --steps bit for bit
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --smoke --device cpu --ep --fused --steps 4 --inject oom@1 \
      --checkpoint-dir /path/to/ckpt --checkpoint-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --smoke --device cpu --ep --fused --steps 6 \
      --checkpoint-dir /path/to/ckpt --checkpoint-every 2 --resume

Training on the card runs the EP strategy with the fused expert leg
(``--ep --fused``).  The EP strategy's ragged leg trains too, through
``Trainer`` with ``DistContext(moe_strategy="ep_shardmap", moe_ragged=True)``;
the JAX launcher has no flag for it, and neither has this one.  The local
path and the EP capacity layout run the grouped kernels, which have no
backward: on the card, training on them raises, as training them through
Pallas raises in the JAX package.

``--mesh DxP`` runs D x P ranks (``launch/mesh.py``): the world comes from
the environment under ``torchrun``, or ``--nproc D*P`` spawns the ranks
itself.  The backend is NCCL when every rank has a card of its own, gloo
otherwise (several ranks on one card, or the CPU).  Rank 0 prints the log;
every rank prints its schedule trace and, on a card, its own peak memory.
``--mesh local`` (the default) and ``--mesh 1x1`` are one EP peer.  Under a
mesh every rank gets the same flags (the same ``--inject`` faults, the same
planner flags, the same ``--checkpoint-dir``, where each rank writes its own
files), and every rank plans the same schedules and placements.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from pathlib import Path

from repro_torch.launch import mesh as mesh_lib


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
    ap.add_argument("--adaptive-mact", action="store_true",
                    help="per-layer (bin, depth) schedules from the online "
                         "expert-load telemetry EMA")
    ap.add_argument("--replan-interval", type=int, default=1,
                    help="steps between adaptive MACT re-plans")
    ap.add_argument("--mact-hysteresis", type=float, default=0.1,
                    help="load-margin hysteresis band: a layer's schedule moves "
                         "only when the re-plan survives (1+h)x load noise or "
                         "memory safety forces it")
    ap.add_argument("--mact-headroom", type=float, default=0.2,
                    help="plan each layer for (1+this)*EMA load, the margin that "
                         "keeps a drifting layer's schedule ahead of its load "
                         "between re-plans")
    ap.add_argument("--placement", action="store_true",
                    help="telemetry-driven expert placement: move (and with "
                         "--placement-replicas, replicate) experts over the EP "
                         "peers at re-plans")
    ap.add_argument("--placement-replicas", type=int, default=0,
                    help="extra hot-expert weight slots per EP peer")
    ap.add_argument("--placement-hysteresis", type=float, default=0.1,
                    help="least fractional bottleneck improvement before a "
                         "layer's placement moves")
    ap.add_argument("--remat", default=None, choices=["none", "full", "memfine"])
    ap.add_argument("--ep", action="store_true",
                    help="the EP strategy (the path that trains): at one peer, "
                         "or across the ranks of --mesh")
    ap.add_argument("--fused", action="store_true",
                    help="the fused expert leg over the ragged layout "
                         "(kernels/fused_moe.py); MACT plans with the reduced "
                         "Eq. 2 term; needs --ep")
    ap.add_argument("--mesh", default="local",
                    help="local (one EP peer) or DxP: D data x P EP ranks, from "
                         "torchrun's environment or spawned with --nproc")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (D*P of --mesh) instead of "
                         "reading them from torchrun's environment")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest VALID checkpoint in --checkpoint-dir "
                         "(corrupt saves are skipped) and train until --steps "
                         "total steps")
    ap.add_argument("--max-oom-retries", type=int, default=4,
                    help="degradation-ladder bound per step")
    ap.add_argument("--inject", default=None,
                    help="faults, e.g. 'oom@3,burst@2x1.5,ckpt_truncate@4' "
                         "(kind@step[xMAG][*TIMES])")
    ap.add_argument("--log-json", default=None,
                    help="write the log here (under a mesh, one file per rank: "
                         "NAME.rankR.json)")
    args = ap.parse_args(argv)
    if args.fused and not args.ep:
        ap.error("--fused needs --ep (the fused leg is the EP strategy's)")
    try:
        args.mesh_shape = mesh_lib.parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if args.mesh_shape is not None and not args.ep:
        ap.error("--mesh needs --ep: only the EP strategy runs across ranks")
    ranks = 1 if args.mesh_shape is None else args.mesh_shape[0] * args.mesh_shape[1]
    if args.nproc and args.nproc != ranks:
        ap.error(f"--nproc {args.nproc} is not the rank count of --mesh {args.mesh}")
    return args


def main(argv=None):
    """Parse ``argv`` and train; returns (trainer, final state) to an
    in-process caller, None after spawning the ranks (``--nproc``)."""
    args = parse_args(argv)
    if args.nproc > 1:
        _spawn(args)
        return None
    return train(args)


def _spawn(args) -> None:
    """Run ``args.nproc`` ranks with the spawn start method (CUDA cannot be
    forked), joined through a file store; raises if a rank fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(args, f"file://{tmp}/store"),
                           nprocs=args.nproc, start_method="spawn")


def _rank_main(rank: int, args, init_method: str) -> None:
    import os

    import torch
    import torch.distributed as dist
    # the ranks share the host's cores: a thread per core in each of them
    # oversubscribes the cores many times over
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nproc))
    try:
        train(args, rank=rank, init_method=init_method)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train(args, rank=None, init_method=None):
    """Train as ``args`` say; under a mesh this process is one rank (of
    ``torchrun`` when ``rank`` is None)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.training.trainer import Trainer

    device = resolve_device(args.device)
    mesh = None
    if args.mesh_shape is not None:
        D, P = args.mesh_shape
        device = (mesh_lib.init_world_from_env(device) if rank is None else
                  mesh_lib.init_world(rank, D * P, init_method, device))
        mesh = mesh_lib.make_host_mesh(args.mesh_shape)
    lead = mesh is None or mesh.rank == 0
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
                      moe_fused=args.fused, mesh=mesh)
    trainer = Trainer(cfg, ctx, seq_len=args.seq_len,
                      global_batch=args.global_batch, lr=args.lr, seed=args.seed,
                      dtype=getattr(torch, dtype), use_mact=not args.no_mact,
                      max_pipeline_depth=depth, adaptive_mact=args.adaptive_mact,
                      replan_interval=args.replan_interval,
                      mact_hysteresis=args.mact_hysteresis,
                      mact_headroom=args.mact_headroom, use_placement=args.placement,
                      placement_replicas=args.placement_replicas,
                      placement_hysteresis=args.placement_hysteresis,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every, resume=args.resume,
                      max_oom_retries=args.max_oom_retries,
                      injector=(FaultInjector.from_string(args.inject)
                                if args.inject else None))
    ep = ("local path" if not args.ep else "EP at one peer" if mesh is None else
          f"EP over a {mesh.shape[0]}x{mesh.shape[1]} mesh")
    if lead:
        print(f"training {cfg.name} ({cfg.num_layers} layers, {dtype}, {device}): "
              f"seq {args.seq_len} x batch {args.global_batch}, {ep}"
              f"{', fused expert leg' if args.fused else ''}, "
              f"MACT {'off' if args.no_mact else 'adaptive' if args.adaptive_mact else 'on'}"
              f"{', expert placement' if args.placement else ''}", flush=True)
    state = trainer.fit(args.steps, verbose=lead)
    who = "" if mesh is None else f"rank {mesh.rank}: "
    if trainer.resumed_from is not None:
        print(f"{who}resumed from checkpoint step {trainer.resumed_from}", flush=True)
    if trainer.guard.escalations:
        print(f"{who}OOM ladder: {len(trainer.guard.escalations)} escalation(s), "
              f"headroom now {trainer.mact_headroom:.2f}", flush=True)
    if trainer.log:
        print(f"{who}final loss {trainer.log[-1]['loss']:.4f} at step "
              f"{trainer.log[-1]['step']}; chunk trace {trainer.chunk_trace[-8:]}; "
              f"pipeline trace {trainer.pipeline_trace[-8:]}", flush=True)
    else:
        print(f"{who}nothing to do: checkpoint already at step {state.step} "
              f">= target {args.steps}", flush=True)
    if args.placement and trainer.placement_trace:
        last = trainer.placement_trace[-1]
        imb = last["imbalance"]
        print(f"{who}placement: {len(trainer.placement_trace)} replan(s), last moved "
              f"{last['migrated_slots']} slots ({last['migrated_bytes'] / 2**20:.1f} "
              f"MiB a step through the weight exchange), imbalance "
              f"{'n/a' if imb is None else f'{max(imb):.2f}'}", flush=True)
    if args.adaptive_mact and trainer.schedule_trace:
        print(f"{who}adaptive layer schedules (last plan): "
              f"{[tuple(s) for s in trainer.schedule_trace[-1]]}", flush=True)
    if trainer.max_memory_allocated is not None:
        print(f"{who}peak device memory (max_memory_allocated) "
              f"{trainer.max_memory_allocated / 1e9:.2f} GB on "
              f"{torch.cuda.get_device_name(device)}", flush=True)
    if args.log_json:
        path = Path(args.log_json)
        if mesh is not None:
            path = path.with_name(f"{path.stem}.rank{mesh.rank}{path.suffix}")
        path.write_text(json.dumps(trainer.log, indent=1))
    return trainer, state


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():            # a torchrun rank
        dist.destroy_process_group()
