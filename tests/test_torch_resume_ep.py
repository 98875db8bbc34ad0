"""The resilience path on 2 gloo ranks (a 1x2 mesh) on the CPU: per-rank
checkpoints, where one rank's torn payload invalidates the step for both;
kill-and-resume bit for bit on every rank; an injected OOM walked by both
ranks in lockstep; and kill-and-resume of a placed, adaptive run (per-layer
schedules, a replica slot per rank, layer 0's router zeroed so that its
tokens start on experts 0 and 1), whose planner state (telemetry, schedule and placement vectors
and their ages) the checkpoint carries.

The ranks are spawned and joined through a ``FileStore`` under the test's
temporary directory; the worker below and this module's top level import
no JAX (the ranks import this module by name).  Every join has a timeout.
The reduced Mixtral in fp32, seq 32, global batch 2 (one sequence a rank).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

CPU = torch.device("cpu")
JOIN_S = 240
KW = dict(seq_len=32, global_batch=2, lr=1e-3)


def _resume_worker(rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch import checkpointing
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import param_list
    from repro_torch.runtime.faults import FaultInjector, SimulatedCrash
    from repro_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    try:
        mesh_lib.init_world(rank, 2, store, "cpu")
        mesh = mesh_lib.make_host_mesh((1, 2))
        cfg = get_config("mixtral-8x7b").reduced()
        ctx = DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True, mesh=mesh)
        a_dir, b_dir = str(Path(out_dir, "a")), str(Path(out_dir, "b"))
        a = Trainer(cfg, ctx, checkpoint_dir=a_dir, checkpoint_every=2,
                    injector=FaultInjector.from_string("oom@1"), **KW)
        state_a = a.fit(4)
        b = Trainer(cfg, ctx, checkpoint_dir=b_dir, checkpoint_every=2,
                    injector=FaultInjector.from_string("oom@1,crash@3"), **KW)
        try:
            b.fit(4)
            crashed = False
        except SimulatedCrash:
            crashed = True
        c = Trainer(cfg, ctx, checkpoint_dir=b_dir, resume=True, **KW)
        state_c = c.fit(4)
        leaves = lambda s: param_list(s.params) + s.opt.mu + s.opt.nu  # noqa: E731
        rec = {"crashed": crashed, "resumed_from": c.resumed_from,
               "bit_equal": all(torch.equal(x, y)
                                for x, y in zip(leaves(state_a), leaves(state_c))),
               "steps": [state_a.step, state_c.step],
               "losses_a": [r["loss"] for r in a.log], "losses_c": [r["loss"] for r in c.log],
               "retries_a": [r["oom_retries"] for r in a.log],
               "escalations": [(e["failed"], e["next"]) for e in a.guard.escalations],
               "files_b": sorted(os.listdir(b_dir)),
               "valid_before": checkpointing.valid_steps(a_dir, world=2)}
        mesh.barrier()
        if rank == 1:                         # tear this rank's newest payload only
            path = checkpointing.payload(a_dir, 4, rank, 2)
            os.truncate(path, os.path.getsize(path) // 2)
        mesh.barrier()
        rec["valid_after"] = checkpointing.valid_steps(a_dir, world=2)
        rec["latest_after"] = checkpointing.latest_step(a_dir, world=2)
        rec["valid_one_peer"] = checkpointing.valid_steps(a_dir)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _placed_resume_worker(rank: int, store: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.moe import DistContext
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim.adamw import param_list
    from repro_torch.runtime.faults import FaultInjector, SimulatedCrash
    from repro_torch.training.step import init_train_state
    from repro_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    try:
        mesh_lib.init_world(rank, 2, store, "cpu")
        mesh = mesh_lib.make_host_mesh((1, 2))
        cfg = get_config("mixtral-8x7b").reduced()
        ctx = DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True, mesh=mesh)
        kw = dict(KW, adaptive_mact=True, use_placement=True, placement_replicas=1,
                  placement_hysteresis=0.0)

        def skewed():
            # a zero router ties every score, and top-2 breaks ties to (0, 1)
            state = init_train_state(cfg, device=CPU, seed=0, mesh=mesh)
            with torch.no_grad():
                state.params["layers"][0]["ffn"]["router"]["w"].zero_()
            return state

        a_dir, b_dir = str(Path(out_dir, "a")), str(Path(out_dir, "b"))
        a = Trainer(cfg, ctx, checkpoint_dir=a_dir, checkpoint_every=2, **kw)
        state_a = a.fit(6, skewed())
        b = Trainer(cfg, ctx, checkpoint_dir=b_dir, checkpoint_every=2,
                    injector=FaultInjector.from_string("crash@3"), **kw)
        try:
            b.fit(6, skewed())
            crashed = False
        except SimulatedCrash:
            crashed = True
        c = Trainer(cfg, ctx, checkpoint_dir=b_dir, resume=True, **kw)
        state_c = c.fit(6)
        leaves = lambda s: param_list(s.params) + s.opt.mu + s.opt.nu  # noqa: E731
        vecs = lambda tr: [[list(s) for s in v] for v in tr.schedule_trace]  # noqa: E731
        rec = {"crashed": crashed, "resumed_from": c.resumed_from,
               "bit_equal": all(torch.equal(x, y)
                                for x, y in zip(leaves(state_a), leaves(state_c))),
               "losses_a": [r["loss"] for r in a.log], "losses_c": [r["loss"] for r in c.log],
               "schedules_a": vecs(a), "schedules_c": vecs(c),
               "placements_a": [r["placements"] for r in a.placement_trace],
               "placements_c": [r["placements"] for r in c.placement_trace],
               "identity_a": [r["identity"] for r in a.placement_trace],
               "imbalance_a": [r["imbalance"] for r in a.placement_trace]}
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_two(target, tmp_path) -> list:
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = f"file://{tmp_path}/store"
    procs = [ctx.Process(target=target, args=(r, store, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), f"ranks did not finish in {JOIN_S} s"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]


def test_kill_and_resume_on_two_ranks(tmp_path):
    recs = _spawn_two(_resume_worker, tmp_path)
    for r, rec in enumerate(recs):
        assert rec["crashed"] and rec["resumed_from"] == 2 and rec["bit_equal"], rec
        assert rec["steps"] == [4, 4]
        assert rec["losses_c"] == rec["losses_a"][2:]
        assert rec["retries_a"] == [0, 1, 0, 0]          # the ladder, in lockstep
        assert rec["escalations"] == [[[2, 2], [2, 1]]]
        assert rec["files_b"] == [f"step_00000002.rank{j}.{ext}" for j in (0, 1)
                                  for ext in ("json", "npz")]
        assert rec["valid_before"] == [2, 4]
        assert rec["valid_after"] == [2] and rec["latest_after"] == 2
        assert rec["valid_one_peer"] == []               # no one-peer files here
    assert recs[0]["losses_a"] == recs[1]["losses_a"]


def test_kill_and_resume_of_a_placed_adaptive_run_on_two_ranks(tmp_path):
    """Killed at step 3 and resumed from step 2: the resumed run's losses,
    schedule vectors and placements are the uninterrupted run's, and its
    parameters and moments equal them bit for bit."""
    recs = _spawn_two(_placed_resume_worker, tmp_path)
    for rec in recs:
        assert rec["crashed"] and rec["resumed_from"] == 2 and rec["bit_equal"], rec
        assert rec["losses_c"] == rec["losses_a"][2:]
        assert rec["schedules_c"] == rec["schedules_a"][2:]
        assert rec["placements_c"] == rec["placements_a"][2:]
        assert rec["identity_a"][0] and not any(rec["identity_a"][1:]), rec
        assert rec["imbalance_a"][1][0] > rec["imbalance_a"][1][1]      # layer 0 skewed
    assert recs[0] == recs[1]
