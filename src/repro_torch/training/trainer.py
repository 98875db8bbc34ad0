"""Training loop with MACT choosing the FCDA schedule (global mode).

Each step:
  1. MACT chooses (chunk bin, pipeline depth) from the previous step's
     router load (s''), through the memory model (Eq. 8-9, with the
     pipeline's extra live chunk), cold-starting from the worst case
     s' -> e*s*k.  Without an EP context the local path has no exchange to
     overlap, so the depth is planned as 1.  MACT reads the global load,
     so every rank picks the same schedule.
  2. The step runs under a ``DistContext`` built for that schedule (PyTorch
     runs eagerly: there is nothing to compile or cache).
  3. The router load feeds back to MACT; the log, ``chunk_trace`` and
     ``pipeline_trace`` record the step.

Under a mesh (``ctx.mesh``, ``launch/mesh.py``) of D x P ranks, MACT plans
with ``Parallelism(e=P, b=global_batch // D)``, as the JAX trainer does for
that mesh.  The tokens are partitioned by whole sequences: rank r = i P + j
takes rows [r b, (r+1) b) of the step's global batch, b = global_batch /
(D P), so attention stays on the rank and the EP ranks are data-parallel
ranks, as in the paper's Megatron layout.  (The JAX package cuts the
sequence over the model axis inside its ``shard_map`` instead; under
dropless routing y, load and drops do not depend on which rank holds a
token.)  The step's gradients follow ``training/step.py``'s contract; the
log's metrics are global and equal on every rank, and ``tgs`` counts the
global tokens.

Resilience: each step runs under the ``OOMGuard`` degradation ladder
(``runtime/guard.py``).  An out-of-memory error (a real
``torch.cuda.OutOfMemoryError`` or an injected one) leaves the state as it
was, because the step is a transaction (``training/step.py``); the guard
releases the failed attempt and retries strictly more conservative
schedules (depth 1, then deeper chunking, then full recompute), and
``_oom_audit`` holds MACT's model against what the failed attempt took on
the card, widening ``mact_headroom`` when the model said the schedule fit.
``resume=True`` makes ``fit`` restore the newest *valid* checkpoint (a torn
save is skipped by the manifest's checksum) with the planner state it
needs (the last observed load), and train on to the target step, bit for
bit as a run that never died.  Under a mesh only injected faults walk the
ladder (every rank sees them); a real OOM is re-raised with its rank named.

Not ported yet (they raise): adaptive per-layer MACT and expert placement.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpointing
from repro_torch.configs.base import H100_80G, HardwareProfile, ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core.mact import MACTController
from repro_torch.core.memory_model import Parallelism
from repro_torch.core.moe import DistContext, is_ep
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.guard import FULL_REMAT, DegradationLadder, OOMGuard
from repro_torch.training.step import (TrainState, init_train_state,
                                       make_train_step)

_NOT_PORTED = ("adaptive_mact", "use_placement")


@dataclass
class Trainer:
    cfg: ModelConfig
    ctx: DistContext
    seq_len: int
    global_batch: int
    lr: float = 3e-4
    seed: int = 0
    dtype: torch.dtype = torch.float32
    hw: HardwareProfile = H100_80G
    use_mact: bool = True
    max_pipeline_depth: int = 2          # MACT may pick depth in [1, this]
    adaptive_mact: bool = False
    use_placement: bool = False
    mact_headroom: float = 0.2           # adaptive MACT's planning margin
                                         # (not ported yet); the OOM audit
                                         # widens it and checkpoints carry it
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    resume: bool = False                 # fit() restores the newest valid
                                         # checkpoint and treats `steps` as
                                         # the TARGET step count
    injector: Optional[FaultInjector] = None   # chaos hooks (runtime/faults)
    max_oom_retries: int = 4             # ladder bound per step
    headroom_widen: float = 1.5          # audit: multiply mact_headroom by
                                         # this when the model under-predicts
    log: list = field(default_factory=list)
    chunk_trace: list = field(default_factory=list)
    pipeline_trace: list = field(default_factory=list)
    checkpoint_log: list = field(default_factory=list)  # saves and the
                                         # resume: bytes and seconds

    def __post_init__(self):
        for name in _NOT_PORTED:
            if getattr(self, name):
                raise NotImplementedError(f"Trainer({name}=...) is not ported yet")
        mesh = self.ctx.mesh
        D, P = mesh.shape if mesh is not None else (1, 1)
        if self.global_batch % (D * P):
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"into whole sequences over {D * P} ranks")
        self.par = Parallelism(e=P if self.cfg.moe is not None else 1,
                               b=max(1, self.global_batch // D))
        rows = self.global_batch // (D * P)
        rank = mesh.rank if mesh is not None else 0
        self._rows = slice(rank * rows, (rank + 1) * rows)
        self.mact = MACTController(self.cfg, self.par, self.hw, self.seq_len,
                                   fused=self.ctx.moe_fused)
        self.data = SyntheticLMData(self.cfg, self.seq_len, self.global_batch,
                                    self.seed)
        self._last_load: Optional[np.ndarray] = None
        # this rank and the rank count, for the checkpoint's file names
        self._rank, self._world = (rank, mesh.size) if mesh is not None else (0, 1)
        self.guard = OOMGuard(
            DegradationLadder(self.mact.schedule_space(self.max_pipeline_depth)),
            max_retries=self.max_oom_retries, on_oom=self._oom_audit,
            rank=self._rank if self._world > 1 else None)
        self.headroom_widenings: list = []
        self.resumed_from: Optional[int] = None
        # the run's peak on the card, over its attempts (each attempt resets
        # the allocator's peak, so an OOM's audit reads its own); None on the CPU
        self.max_memory_allocated: Optional[int] = None

    def _plan_params(self) -> tuple:
        """(ep_view, max_depth): the local path has no exchange to overlap,
        so it plans sequential-only."""
        ep_view = self.par.e
        max_depth = self.max_pipeline_depth if is_ep(self.cfg.moe, self.ctx) else 1
        return ep_view, max_depth

    def choose_schedule(self) -> tuple:
        """(chunks, pipeline depth) for the next step, MACT-selected.  As in
        the JAX package, s'' comes from the load summed over every MoE
        layer: conservative on memory by up to the MoE layer count."""
        if not self.use_mact or self.cfg.moe is None:
            return self.ctx.moe_chunks, self.ctx.pipeline_chunks
        ep_view, max_depth = self._plan_params()
        return self.mact.choose_schedule(self._last_load, ep_size=ep_view,
                                         max_depth=max_depth)

    def _context(self, chunks: int, pipeline: int) -> DistContext:
        return dataclasses.replace(self.ctx, moe_chunks=chunks,
                                   pipeline_chunks=pipeline)

    def _step_for(self, key: tuple):
        """The step function of a schedule key: (chunks, depth), or the
        ladder's floor (FULL_REMAT, largest bin), which runs the largest bin
        at depth 1 with every layer recomputed (``remat_policy="full"``)."""
        cfg = self.cfg
        if key and key[0] == FULL_REMAT:
            cfg = dataclasses.replace(cfg, remat_policy="full")
        return make_train_step(cfg, self._context(*self._key_summary(key)), lr=self.lr)

    # -- resilience -------------------------------------------------------------

    @staticmethod
    def _key_summary(key: tuple) -> tuple:
        """(chunks, pipeline) actually run for a schedule key."""
        if key[0] == FULL_REMAT:
            return key[1], 1
        return key

    def _measured(self, exc: Exception) -> dict:
        """What the failed attempt took on the card (GiB, as MACT's report):
        the allocator's peaks since the attempt began, and the allocation it
        refused.  None on the CPU."""
        dev = self.ctx.device
        if torch.device(dev).type != "cuda":
            return {"peak_allocated_gb": None, "peak_reserved_gb": None,
                    "tried_gb": None}
        m = re.search(r"Tried to allocate ([\d.]+) (GiB|MiB|KiB|B)", str(exc))
        tried = (float(m.group(1)) / {"GiB": 1, "MiB": 2**10, "KiB": 2**20,
                                      "B": 2**30}[m.group(2)] if m else None)
        return {"peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
                "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 2**30,
                "tried_gb": tried}

    def _oom_audit(self, key: tuple, exc: Exception, step: int) -> dict:
        """Post-hoc memory-model audit after an OOM: MACT's modeled bytes
        beside what the failed attempt took, and a wider planning headroom
        when the model said the failed schedule fit (it under-predicted)."""
        chunks, depth = self._key_summary(key)
        if self._last_load is not None:
            s_pp = self.mact.observed_s_pp(self._last_load, self._plan_params()[0])
        else:
            s_pp = mm.worst_case_s_prime(self.seq_len, self.par, self.mact.dims.topk)
        report = self.mact.memory_report(s_pp, chunks, depth)
        audit = {"step": step, "key": key, "s_pp": float(s_pp),
                 "modeled_total_gb": report["total_gb"],
                 "modeled_fits": bool(report["fits"]), "error": str(exc),
                 **self._measured(exc)}
        if report["fits"]:
            before = self.mact_headroom
            self.mact_headroom = before * self.headroom_widen + 1e-2
            audit["headroom"] = (before, self.mact_headroom)
            self.headroom_widenings.append(audit["headroom"])
        return audit

    def _runtime_extra(self) -> dict:
        """Host-side planner state a checkpoint must carry for a resumed run
        to plan as the uninterrupted one did: without ``last_load`` the step
        after a resume plans cold, from the worst case, and runs another
        chunk count.  The JAX package's keys for telemetry, layer schedules
        and placements are null until adaptive MACT and placement are
        ported."""
        return {"telemetry": None,
                "last_load": (None if self._last_load is None
                              else np.asarray(self._last_load).tolist()),
                "layer_schedules": None, "plan_age": None,
                "mact_headroom": self.mact_headroom,
                "placements": None, "placement_age": None}

    def _apply_extra(self, extra: dict) -> None:
        if extra.get("last_load") is not None:
            self._last_load = np.asarray(extra["last_load"])
        self.mact_headroom = float(extra.get("mact_headroom", self.mact_headroom))

    def _resume_state(self) -> Optional[TrainState]:
        """Restore the newest VALID checkpoint (corrupt ones are skipped by
        the manifest checksum) and the planner state; None if the directory
        holds nothing restorable."""
        ckpt, rank, world = self.checkpoint_dir, self._rank, self._world
        t0 = time.perf_counter()
        step = checkpointing.latest_step(ckpt, world=world)
        verify_s = time.perf_counter() - t0
        if step is None:
            return None
        like = init_train_state(self.cfg, self.dtype, self.ctx.device, self.seed,
                                mesh=self.ctx.mesh)
        t0 = time.perf_counter()
        state = checkpointing.restore(ckpt, step, like, rank=rank, world=world)
        restore_s = time.perf_counter() - t0
        self._apply_extra(checkpointing.load_extra(ckpt, step, rank=rank, world=world))
        self.resumed_from = step
        self.checkpoint_log.append({
            "resumed_from": step, "verify_s": verify_s, "restore_s": restore_s,
            "bytes": os.path.getsize(checkpointing.payload(ckpt, step, rank, world))})
        return state

    def _checkpoint(self, state: TrainState, step_idx: int, verbose: bool) -> None:
        t0 = time.perf_counter()
        path = checkpointing.save(self.checkpoint_dir, state.step, state,
                                  extra=self._runtime_extra(), rank=self._rank,
                                  world=self._world)
        rec = {"step": state.step, "bytes": os.path.getsize(path),
               "save_s": time.perf_counter() - t0}
        self.checkpoint_log.append(rec)
        if verbose:
            print(f"checkpoint step {rec['step']}: {rec['bytes'] / 1e9:.3f} GB in "
                  f"{rec['save_s']:.2f} s", flush=True)
        if self.injector is not None:
            self.injector.maybe_truncate_checkpoint(
                step_idx, self.checkpoint_dir,
                rank=self._rank if self._world > 1 else None)

    def fit(self, steps: int, state: Optional[TrainState] = None,
            verbose: bool = False) -> TrainState:
        """Run ``steps`` steps from ``state`` (default: fresh weights from
        ``seed`` on the context's device).  Under ``resume=True`` ``steps``
        is the TARGET step count: fit restores the newest valid checkpoint
        and trains the remainder, so a crash and a re-run end on the same
        step as an uninterrupted run."""
        if state is None and self.resume and self.checkpoint_dir:
            state = self._resume_state()
            if state is not None and verbose:
                last = self.checkpoint_log[-1]
                print(f"restored checkpoint step {self.resumed_from}: "
                      f"{last['bytes'] / 1e9:.3f} GB, verify {last['verify_s']:.2f} s, "
                      f"restore {last['restore_s']:.2f} s", flush=True)
        if state is None:
            state = init_train_state(self.cfg, self.dtype, self.ctx.device,
                                     self.seed, mesh=self.ctx.mesh)
        dev = torch.device(self.ctx.device)
        if dev.type == "cuda":                   # the state, at least
            self._fold_peak(torch.cuda.memory_allocated(dev))
        n = steps - state.step if self.resume else steps
        for _ in range(max(n, 0)):
            step_idx = state.step
            key = tuple(self.choose_schedule())
            batch = {k: torch.as_tensor(v[self._rows], device=dev)
                     for k, v in self.data.batch_at(step_idx).items()}

            def attempt(k, _state=state, _batch=batch, _step=step_idx):
                if self.injector is not None:
                    self.injector.maybe_fail_step(_step)   # oom/crash hooks
                    self.injector.maybe_stall(_step)
                if dev.type == "cuda":               # this attempt's own peak
                    torch.cuda.reset_peak_memory_stats(dev)
                try:
                    new_state, metrics = self._step_for(k)(_state, _batch)
                    # the step's one sync point: a real OOM surfaces by here
                    loss = float(metrics["loss"])
                finally:
                    if dev.type == "cuda":
                        self._fold_peak(torch.cuda.max_memory_allocated(dev))
                return new_state, metrics, loss

            t0 = time.perf_counter()
            n_esc = len(self.guard.escalations)
            (state, metrics, loss), used = self.guard.run(key, attempt, step_idx)
            dt = time.perf_counter() - t0
            chunks, pipeline = self._key_summary(used)
            burst = (self.injector.burst_factor(step_idx)
                     if self.injector is not None else 1.0)
            load = metrics["load"].cpu().numpy() * burst
            self._last_load = load
            tgs = self.global_batch * self.seq_len / max(dt, 1e-9)
            rec = {"step": state.step, "loss": loss,
                   "ce": float(metrics["ce"]), "aux": float(metrics["aux"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "chunks": chunks, "pipeline": pipeline, "time_s": dt,
                   "tgs": tgs, "max_load": float(load.max()),
                   "drops": float(metrics["drops"]),
                   "oom_retries": len(self.guard.escalations) - n_esc}
            if self.par.e > 1:
                # token-slots each model index's experts received, summed
                # over the data groups and the MoE layers (at D = 1, each
                # EP rank's received rows): the cross-rank imbalance
                rec["recv_by_peer"] = load.reshape(self.par.e, -1).sum(1).tolist()
            self.log.append(rec)
            self.chunk_trace.append(chunks)
            self.pipeline_trace.append(pipeline)
            if verbose:
                retries = (f" oom_retries={rec['oom_retries']}"
                           if rec["oom_retries"] else "")
                print(f"step {rec['step']:4d} loss {loss:.4f} c={chunks} "
                      f"depth={pipeline} {dt:.2f}s tgs={tgs:,.0f}{retries}", flush=True)
            if (self.checkpoint_dir and self.checkpoint_every
                    and state.step % self.checkpoint_every == 0):
                self._checkpoint(state, step_idx, verbose)
        return state

    def _fold_peak(self, nbytes: int) -> None:
        self.max_memory_allocated = max(self.max_memory_allocated or 0, nbytes)
