"""Training loop with MACT choosing the FCDA schedule.

Each step:
  1. MACT chooses the FCDA schedule from the previous step's router load
     (s''), through the memory model (Eq. 8-9, with the pipeline's extra
     live chunk), cold-starting from the worst case s' -> e*s*k.  Without
     an EP context the local path has no exchange to overlap, so the depth
     is planned as 1.  Global mode picks one (chunk bin, pipeline depth)
     from the load summed over the MoE layers; adaptive mode
     (``adaptive_mact=True``) resolves one ScheduleSpec per MoE layer from
     the telemetry EMA of each layer's load (core/telemetry.py), re-planned
     every ``replan_interval`` steps with load-margin hysteresis.  MACT
     reads global loads, so every rank plans the same schedules.
  2. With ``use_placement=True`` the same re-plan first moves each MoE
     layer's experts over the EP peers (core/placement.py: LPT, hot-expert
     replicas, a hysteresis band), so that MACT prices each layer's s''
     through the placement it will run under; ``placement_trace`` records
     each re-plan.  Without a mesh the placement is planned over
     ``mact_ep_view`` peers and priced, not applied (core/ep.py).
  3. The step runs under a ``DistContext`` built for that schedule key and
     placement vector.  PyTorch runs eagerly, so there is no compiled step
     to cache (the JAX trainer keeps an LRU of compiled steps per key).
  4. The router loads feed back to MACT and the telemetry; the log,
     ``chunk_trace``, ``pipeline_trace`` and ``schedule_trace`` record the
     step.

Under a mesh (``ctx.mesh``, ``launch/mesh.py``) of D x P ranks, MACT plans
with ``Parallelism(e=P, b=global_batch // D)``, as the JAX trainer does for
that mesh.  The tokens are partitioned by whole sequences: rank r = i P + j
takes rows [r b, (r+1) b) of the step's global batch, b = global_batch /
(D P), so attention stays on the rank and the EP ranks are data-parallel
ranks, as in the paper's Megatron layout.  (The JAX package cuts the
sequence over the model axis inside its ``shard_map`` instead; under
dropless routing y, load and drops do not depend on which rank holds a
token, while a replicated expert's split over its replicas does.)  The
step's gradients follow ``training/step.py``'s contract; the log's metrics
are global and equal on every rank, and ``tgs`` counts the global tokens.

Resilience: each step runs under the ``OOMGuard`` degradation ladder
(``runtime/guard.py``), over schedule keys (a per-layer vector escalates
from its least chunked layer).  An out-of-memory error (a real
``torch.cuda.OutOfMemoryError`` or an injected one) leaves the state as it
was, because the step is a transaction (``training/step.py``); the guard
releases the failed attempt and retries strictly more conservative
schedules (depth 1, then deeper chunking, then full recompute), and
``_oom_audit`` holds MACT's model against what the failed attempt took on
the card, widening ``mact_headroom`` (and forcing a fresh per-layer plan)
when the model said the schedule fit.  ``resume=True`` makes ``fit``
restore the newest *valid* checkpoint (a torn save is skipped by the
manifest's checksum) with the planner state it needs (the last observed
load, the telemetry EMA, the schedule and placement vectors and their
ages), and train on to the target step, bit for bit as a run that never
died.  Under a mesh only injected faults walk the ladder (every rank sees
them); a real OOM is re-raised with its rank named.
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
from repro_torch.core import placement as plc
from repro_torch.core.chunking import ScheduleSpec
from repro_torch.core.mact import MACTController
from repro_torch.core.memory_model import Parallelism
from repro_torch.core.moe import DistContext, is_ep
from repro_torch.core.placement import PlacementSpec
from repro_torch.core.telemetry import LoadTelemetry
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.transformer import num_moe_layers
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.guard import FULL_REMAT, DegradationLadder, OOMGuard
from repro_torch.training.step import (TrainState, init_train_state,
                                       make_train_step)


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
    mact_bins: tuple = (1, 2, 4, 8)
    use_mact: bool = True
    max_pipeline_depth: int = 2          # MACT may pick depth in [1, this]
    mact_ep_view: Optional[int] = None   # plan as if over this many EP peers
    adaptive_mact: bool = False          # per-layer schedules from telemetry
    replan_interval: int = 1             # steps between adaptive re-plans
    mact_hysteresis: float = 0.1         # load-margin band for schedule moves
    mact_headroom: float = 0.2           # plan for (1+this)*EMA: the drift a
                                         # plan must survive between re-plans;
                                         # the OOM audit widens it
    telemetry_decay: float = 0.6         # per-layer load EMA retention
    use_placement: bool = False          # move and replicate experts over the
                                         # EP peers at re-plans
    placement_replicas: int = 0          # extra hot-expert weight slots per
                                         # EP peer (0 = pure permutation)
    placement_hysteresis: float = 0.1    # least fractional bottleneck gain
                                         # before a layer's placement moves
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
    schedule_trace: list = field(default_factory=list)   # adaptive: vectors
    placement_trace: list = field(default_factory=list)  # per re-plan:
                                         # imbalance, slots migrated, bytes
    checkpoint_log: list = field(default_factory=list)  # saves and the
                                         # resume: bytes and seconds

    def __post_init__(self):
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
        self.mact = MACTController(
            self.cfg, self.par, self.hw, self.seq_len, bins=self.mact_bins,
            fused=self.ctx.moe_fused,
            replica_slots=self.placement_replicas if self.use_placement else 0)
        self.data = SyntheticLMData(self.cfg, self.seq_len, self.global_batch,
                                    self.seed)
        self._last_load: Optional[np.ndarray] = None
        self._n_moe = num_moe_layers(self.cfg)
        self.telemetry = LoadTelemetry(
            self._n_moe, self.cfg.moe.num_experts if self.cfg.moe else 1,
            decay=self.telemetry_decay)
        self._layer_schedules: Optional[tuple] = None
        self._plan_age = 0
        self._placements: Optional[tuple] = None
        self._placement_age = 0
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
        """(ep_view, max_depth) both planning modes share: the local path
        has no exchange to overlap, so it plans sequential-only."""
        ep_view = self.mact_ep_view or max(self.par.e, 1)
        max_depth = self.max_pipeline_depth if is_ep(self.cfg.moe, self.ctx) else 1
        return ep_view, max_depth

    def choose_schedule(self) -> tuple:
        """(chunks, pipeline depth) for the next step, MACT-selected.  As in
        the JAX package, s'' comes from the load summed over every MoE
        layer: conservative on memory by up to the MoE layer count.  The
        adaptive path plans from each layer's own row instead."""
        if not self.use_mact or self.cfg.moe is None:
            return self.ctx.moe_chunks, self.ctx.pipeline_chunks
        ep_view, max_depth = self._plan_params()
        return self.mact.choose_schedule(self._last_load, ep_size=ep_view,
                                         max_depth=max_depth)

    def choose_layer_schedules(self) -> tuple:
        """The per-layer ScheduleSpec vector for the next step (adaptive
        MACT): re-planned from the telemetry EMA at cold start and every
        ``replan_interval`` steps, reused in between."""
        if self._layer_schedules is None or self._plan_age >= self.replan_interval:
            ep_view, max_depth = self._plan_params()
            self._layer_schedules = self.mact.choose_layer_schedules(
                self.telemetry.loads, self._n_moe, ep_size=ep_view,
                max_depth=max_depth, current=self._layer_schedules,
                hysteresis=self.mact_hysteresis, headroom=self.mact_headroom,
                placements=self._placements)
            self._plan_age = 0
        self._plan_age += 1
        return self._layer_schedules

    # -- expert placement ------------------------------------------------------
    def _placement_peers(self) -> int:
        """The EP peers placements map over: the mesh's EP group, else the
        planning view (a run at one peer plans and prices placements as it
        plans schedules; core/ep.py does not apply them there)."""
        if self.ctx.mesh is not None:
            return max(self.par.e, 1)
        return self.mact_ep_view or max(self.par.e, 1)

    def choose_placements(self) -> Optional[tuple]:
        """The per-MoE-layer PlacementSpec vector, re-planned from the
        telemetry EMA at the schedules' cadence (before them, so MACT
        prices each layer through its new map).  Each re-plan appends to
        ``placement_trace`` the per-layer imbalance it acted on, the weight
        slots whose expert changed (``migrated_slots``) and the bytes the
        port's weight exchange moves each step under the new vector
        (``migrated_bytes``: every slot holding another rank's expert,
        over the EP group and the layers, in the weights' type)."""
        peers = self._placement_peers()
        E = self.cfg.moe.num_experts if self.cfg.moe else 0
        if not self.use_placement or self._n_moe == 0 or peers <= 1 or E % peers:
            return None
        if self._placements is None or self._placement_age >= self.replan_interval:
            old = self._placements
            self._placements = plc.choose_placements(
                self.telemetry.loads, self._n_moe, peers, num_experts=E,
                replicas=self.placement_replicas, current=old,
                hysteresis=self.placement_hysteresis)
            self._placement_age = 0
            moved = sum(
                plc.migrated_slots(old[j] if old is not None else None,
                                   self._placements[j])
                for j in range(self._n_moe)) if old != self._placements else 0
            imb = self.telemetry.imbalance()
            e_local = E // peers
            foreign = sum(1 for spec in self._placements
                          for s, e in enumerate(spec.slot_to_expert)
                          if e // e_local != s // spec.slots_per_peer)
            slot_bytes = (3 * self.cfg.d_model * self.cfg.moe.d_ff_expert
                          * torch.empty((), dtype=self.dtype).element_size())
            self.placement_trace.append({
                "step": len(self.log),
                "imbalance": None if imb is None else [float(v) for v in imb],
                "migrated_slots": int(moved),
                "migrated_bytes": float(foreign * slot_bytes),
                "identity": all(p.is_identity for p in self._placements),
                "placements": [list(p.slot_to_expert) for p in self._placements],
            })
        self._placement_age += 1
        return self._placements

    def _with_placements(self, sched_key: tuple) -> tuple:
        """The schedule key with the placement vector attached; identity
        (or no) placement keeps the bare schedule key."""
        p = self._placements
        if p is None or all(s.is_identity for s in p):
            return sched_key
        return (sched_key, p)

    @staticmethod
    def _vector_key(vec: tuple) -> tuple:
        """A per-layer vector as a schedule key: a uniform vector is the
        global key, so it runs the global path."""
        vec = tuple(ScheduleSpec(*s) for s in vec)
        if len(set(vec)) == 1:
            return (vec[0].chunks, vec[0].depth)
        return vec

    def _next_schedule_key(self) -> tuple:
        """The schedule half of the next step's key (the ladder escalates
        over it; ``_with_placements`` adds the placement half inside the
        attempt).  The placement re-plan runs first."""
        self.choose_placements()
        if (self.adaptive_mact and self.use_mact and self.cfg.moe is not None
                and self._n_moe > 0):
            return self._vector_key(self.choose_layer_schedules())
        if self.ctx.layer_schedules and not self.use_mact:
            return self._vector_key(self.ctx.layer_schedules)   # hand-picked
        return tuple(self.choose_schedule())

    def _context_for(self, key: tuple):
        """(cfg, ctx) of a key: a global (chunks, depth), the ladder's floor
        (FULL_REMAT, largest bin: that bin at depth 1 with every layer
        recomputed, ``remat_policy="full"``), a per-layer vector, or any of
        these with a placement vector attached (``_with_placements``)."""
        sched, placements = key, None
        if (len(key) == 2 and isinstance(key[1], tuple) and key[1]
                and isinstance(key[1][0], PlacementSpec)):
            sched, placements = key
        cfg = self.cfg
        if sched[0] == FULL_REMAT:
            cfg = dataclasses.replace(cfg, remat_policy="full")
            ctx = dataclasses.replace(self.ctx, moe_chunks=sched[1], pipeline_chunks=1,
                                      layer_schedules=None)
        elif isinstance(sched[0], tuple):
            ctx = dataclasses.replace(
                self.ctx, layer_schedules=tuple(ScheduleSpec(*s) for s in sched))
        else:
            ctx = dataclasses.replace(self.ctx, moe_chunks=sched[0],
                                      pipeline_chunks=sched[1], layer_schedules=None)
        if placements is not None:
            ctx = dataclasses.replace(ctx, placements=placements)
        return cfg, ctx

    def _context(self, chunks: int, pipeline: int) -> DistContext:
        return self._context_for((chunks, pipeline))[1]

    def _step_for(self, key: tuple):
        """The step function of a key (``_context_for``)."""
        cfg, ctx = self._context_for(key)
        return make_train_step(cfg, ctx, lr=self.lr)

    # -- resilience -------------------------------------------------------------

    @staticmethod
    def _key_summary(key: tuple) -> tuple:
        """(chunks, pipeline) actually run for a schedule key; for a
        per-layer vector, its memory-binding layer's."""
        if key[0] == FULL_REMAT:
            return key[1], 1
        if isinstance(key[0], tuple):
            return max(s[0] for s in key), max(s[1] for s in key)
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
            self._layer_schedules = None               # a fresh plan next
            self._plan_age = 0
            audit["headroom"] = (before, self.mact_headroom)
            self.headroom_widenings.append(audit["headroom"])
        return audit

    def _runtime_extra(self) -> dict:
        """Host-side planner state a checkpoint must carry for a resumed run
        to plan as the uninterrupted one did (the JAX trainer's keys):
        without it the step after a resume plans cold, from the worst case."""
        return {
            "telemetry": self.telemetry.state_dict(),
            "last_load": (None if self._last_load is None
                          else np.asarray(self._last_load).tolist()),
            "layer_schedules": (None if self._layer_schedules is None
                                else [list(s) for s in self._layer_schedules]),
            "plan_age": self._plan_age,
            "mact_headroom": self.mact_headroom,
            "placements": (None if self._placements is None
                           else [[p.num_experts, p.num_peers, list(p.slot_to_expert)]
                                 for p in self._placements]),
            "placement_age": self._placement_age,
        }

    def _apply_extra(self, extra: dict) -> None:
        if not extra:
            return
        if extra.get("telemetry"):
            self.telemetry.load_state_dict(extra["telemetry"])
        if extra.get("last_load") is not None:
            self._last_load = np.asarray(extra["last_load"])
        if extra.get("layer_schedules") is not None:
            self._layer_schedules = tuple(ScheduleSpec(*s)
                                          for s in extra["layer_schedules"])
        self._plan_age = int(extra.get("plan_age") or 0)
        self.mact_headroom = float(extra.get("mact_headroom", self.mact_headroom))
        if extra.get("placements") is not None:
            self._placements = tuple(
                PlacementSpec(int(e), int(p), tuple(int(s) for s in slots))
                for e, p, slots in extra["placements"])
        self._placement_age = int(extra.get("placement_age") or 0)

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
            key = self._next_schedule_key()
            batch = {k: torch.as_tensor(v[self._rows], device=dev)
                     for k, v in self.data.batch_at(step_idx).items()}

            def attempt(k, _state=state, _batch=batch, _step=step_idx):
                if self.injector is not None:
                    self.injector.maybe_fail_step(_step)   # oom/crash hooks
                    self.injector.maybe_stall(_step)
                if dev.type == "cuda":               # this attempt's own peak
                    torch.cuda.reset_peak_memory_stats(dev)
                try:
                    new_state, metrics = self._step_for(
                        self._with_placements(k))(_state, _batch)
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
            per_layer = (metrics["load_per_layer"].cpu().numpy() * burst
                         if "load_per_layer" in metrics else None)
            if self.adaptive_mact and self._n_moe and per_layer is not None:
                self.telemetry.update(per_layer)
            tgs = self.global_batch * self.seq_len / max(dt, 1e-9)
            rec = {"step": state.step, "loss": loss,
                   "ce": float(metrics["ce"]), "aux": float(metrics["aux"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "chunks": chunks, "pipeline": pipeline, "time_s": dt,
                   "tgs": tgs, "max_load": float(load.max()),
                   "drops": float(metrics["drops"]),
                   "oom_retries": len(self.guard.escalations) - n_esc}
            if self.par.e > 1:
                rec["recv_by_peer"] = self._recv_by_peer(load, per_layer).tolist()
            imb = self.telemetry.imbalance()
            if imb is not None:
                rec["imbalance"] = float(imb.max())
            self.log.append(rec)
            self.chunk_trace.append(chunks)
            self.pipeline_trace.append(pipeline)
            if self.adaptive_mact and self._layer_schedules is not None:
                self.schedule_trace.append(self._layer_schedules)
            if verbose:
                retries = (f" oom_retries={rec['oom_retries']}"
                           if rec["oom_retries"] else "")
                imb_s = f" imb={rec['imbalance']:.2f}" if "imbalance" in rec else ""
                plc_s = ""
                if (self.placement_trace
                        and self.placement_trace[-1]["step"] == len(self.log) - 1):
                    last = self.placement_trace[-1]
                    plc_s = (f" replan[moved={last['migrated_slots']} slots, "
                             f"{last['migrated_bytes'] / 2**20:.1f} MiB a step]")
                print(f"step {rec['step']:4d} loss {loss:.4f} c={chunks} "
                      f"depth={pipeline} {dt:.2f}s tgs={tgs:,.0f}{retries}{imb_s}"
                      f"{plc_s}", flush=True)
            if (self.checkpoint_dir and self.checkpoint_every
                    and state.step % self.checkpoint_every == 0):
                self._checkpoint(state, step_idx, verbose)
        return state

    def _recv_by_peer(self, load: np.ndarray, per_layer) -> np.ndarray:
        """Token-slots each model index's slots received, summed over the
        data groups and the MoE layers (at D = 1, each EP rank's received
        rows): through each layer's placement where one is applied, its
        replicas' share split evenly (the placement's model of the split)."""
        p = self._placements
        if (p is None or per_layer is None or self.ctx.mesh is None
                or p[0].num_peers != self.par.e):
            return load.reshape(self.par.e, -1).sum(1)
        return sum(spec.peer_loads(row) for spec, row in zip(p, per_layer))

    def _fold_peak(self, nbytes: int) -> None:
        self.max_memory_allocated = max(self.max_memory_allocated or 0, nbytes)
