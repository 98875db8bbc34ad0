"""MACT -- Memory-Aware Chunk Tuning (paper section 4.2).

Before training, MACT models memory from the config (Eq. 1-2), inverts it
for the largest admissible per-device received-token count s'_max (Eq. 8),
and derives the chunk count c = ceil(s''/s'_max) (Eq. 9) from the predicted
or observed received tokens s''.  c is snapped to a bin of a threshold set
(the paper's [1, 2, 4, 8]); ``choose_schedule`` picks (chunk bin, pipeline
depth) jointly, preferring the overlapped schedule when its extra live chunk
still fits.  Between steps the trainer feeds back the expert load of the
previous step; with no observation yet MACT plans for the worst case
s' -> e*s*k.  A chip that holds a share of the experts
(``MoEConfig.experts_held``) plans for the slots routed to its own experts:
s'' is their load, the worst case b*s*min(k, h).

``choose_layer_schedules`` is the adaptive per-layer mode: fed the
telemetry EMA of per-layer expert loads (core/telemetry.py), it resolves
one ``ScheduleSpec`` per MoE layer through the same Eq. 2/7/9 model, with
load-margin hysteresis, so a layer's schedule moves only when memory
safety forces it or the re-plan is stable under ``(1 + hysteresis)`` load
noise.  With a placement per layer (core/placement.py) each layer's s''
is read through its placement map.

The port's copy of the JAX package's controller, choice for choice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import HardwareProfile, ModelConfig
from repro_torch.core import memory_model as mm
from repro_torch.core.chunking import ScheduleSpec


@dataclass
class MACTController:
    cfg: ModelConfig
    par: mm.Parallelism
    hw: HardwareProfile
    seq_len: int
    bins: Sequence[int] = (1, 2, 4, 8)
    copies: int = 1                      # m_g: stored activation copies
    dtype_bytes: int = 2
    bytes_per_param: float = mm.TRAIN_STATE_BYTES
    static_override: Optional[float] = None   # a measured M_sta instead
    fused: bool = False                  # fused expert leg: Eq. 2/8 lose the
                                         # 2h dispatch-buffer term
    replica_slots: int = 0               # hot-expert replica slots per peer
    history: list = field(default_factory=list)

    def __post_init__(self):
        self.dims = mm.LayerDims.from_config(self.cfg)
        moe = self.cfg.moe
        self.held = (moe.held if moe is not None and moe.held < moe.num_experts
                     else None)
        self.static = (self.static_override if self.static_override is not None
                       else mm.static_bytes(self.cfg, self.par, self.bytes_per_param))

    # -- Eq. 8 ---------------------------------------------------------------
    def s_prime_max(self) -> float:
        replica = mm.replica_weight_bytes(self.cfg, self.replica_slots, self.par)
        return mm.s_prime_max(self.dims, self.seq_len, self.par, self.hw,
                              self.static, copies=self.copies,
                              dtype_bytes=self.dtype_bytes, fused=self.fused,
                              replica_bytes=replica)

    # -- s'' from router statistics -------------------------------------------
    def observed_s_pp(self, load: np.ndarray, ep_size: Optional[int] = None,
                      placement=None) -> float:
        """Worst per-device received-token count from a global expert-load
        vector (token-slots per expert, summed over the step).  With a
        ``PlacementSpec`` the per-peer sums go through its map (a replicated
        expert's load split over its slots) instead of the contiguous
        identity layout."""
        load = np.asarray(load, dtype=np.float64)
        if self.held is not None:
            return float(load[:self.held].sum())
        if placement is not None:
            return float(placement.peer_loads(load).max())
        e = ep_size or self.par.e
        if load.size % e:
            raise ValueError(
                f"expert-load vector of size {load.size} does not divide "
                f"into ep_size={e} devices; pass the global per-expert load "
                f"(length a multiple of the EP group size) or the matching "
                f"ep_size")
        return float(load.reshape(e, -1).sum(axis=1).max())

    def worst_case_s_pp(self) -> int:
        """s'' with no observation: the worst case (module docstring)."""
        return mm.worst_case_s_prime(self.seq_len, self.par, self.dims.topk, self.held)

    # -- Eq. 9 + threshold binning --------------------------------------------
    def optimal_c(self, s_pp: float) -> int:
        return mm.optimal_chunks(s_pp, self.s_prime_max())

    def snap(self, c: int) -> int:
        """The smallest bin >= c (conservative on memory); the largest bin
        if none covers."""
        for b in sorted(self.bins):
            if b >= c:
                return b
        return max(self.bins)

    def choose(self, load: Optional[np.ndarray] = None,
               ep_size: Optional[int] = None) -> int:
        """The chunk bin for the next step (sequential schedule)."""
        return self.choose_schedule(load, ep_size, max_depth=1)[0]

    def _schedule_for(self, s_pp: float, max_depth: int = 2) -> ScheduleSpec:
        """Pure Eq. 9 schedule choice for one load estimate."""
        s_max = self.s_prime_max()
        for depth in range(max(max_depth, 1), 1, -1):
            c = mm.optimal_chunks(s_pp, s_max, pipeline_depth=depth)
            b = self.snap(c)
            # the bin must cover the deeper schedule's chunks AND split into
            # whole waves, or chunked_pipeline would run the sequential loop
            # while the pipeline's memory is charged
            if b >= c and b % depth == 0:
                return ScheduleSpec(b, depth)
        return ScheduleSpec(self.snap(self.optimal_c(s_pp)), 1)

    def choose_schedule(self, load: Optional[np.ndarray] = None,
                        ep_size: Optional[int] = None, *,
                        max_depth: int = 2) -> tuple:
        """Jointly pick (chunk bin, pipeline depth) for the next step: the
        deepest schedule whose chunk requirement d * s''/c <= s'_max a bin
        still covers, else the sequential one."""
        if load is None:
            s_pp = self.worst_case_s_pp()
        else:
            s_pp = self.observed_s_pp(load, ep_size)
        sched = self._schedule_for(s_pp, max_depth)
        c = mm.optimal_chunks(s_pp, self.s_prime_max(), pipeline_depth=sched.depth)
        self.history.append({"s_pp": s_pp, "c_star": c, "bin": sched.chunks,
                             "depth": sched.depth})
        return tuple(sched)

    def schedule_space(self, max_depth: int = 2) -> tuple:
        """Every schedule the controller can emit."""
        space = [ScheduleSpec(b, 1) for b in sorted(self.bins)]
        for depth in range(2, max(max_depth, 1) + 1):
            space += [ScheduleSpec(b, depth) for b in sorted(self.bins)
                      if b >= depth and b % depth == 0]
        return tuple(space)

    def _admissible(self, sched: ScheduleSpec, s_pp: float) -> bool:
        """Whether ``sched``'s bin covers the Eq. 9 chunk requirement at its
        depth for load ``s_pp``."""
        c = mm.optimal_chunks(s_pp, self.s_prime_max(), pipeline_depth=sched.depth)
        return sched.chunks >= c

    def choose_layer_schedules(self, loads: Optional[np.ndarray], num_layers: int,
                               ep_size: Optional[int] = None, *,
                               max_depth: int = 2,
                               current: Optional[Sequence[ScheduleSpec]] = None,
                               hysteresis: float = 0.0, headroom: float = 0.0,
                               placements: Optional[Sequence] = None) -> tuple:
        """One ``ScheduleSpec`` per MoE layer from per-layer loads.

        ``loads`` is the telemetry's (num_layers, E) EMA, or None at cold
        start, which plans every layer for the worst case.  Each layer's
        estimate is inflated to ``(1 + headroom) * s''``: the EMA trails a
        drifting load and a plan stays in force for a re-plan interval.
        With ``current`` (the vector in force) each layer keeps its
        incumbent unless the incumbent no longer covers the layer's Eq. 9
        requirement (memory safety: switch at once) or the candidate is
        also the choice at ``(1 + hysteresis) * s''`` (outside the band).
        ``placements`` (one PlacementSpec per layer) reads each layer's s''
        through its placement map."""
        if loads is None:
            s_pps = [float(self.worst_case_s_pp())] * num_layers
        else:
            loads = np.asarray(loads, dtype=np.float64)
            if loads.ndim != 2 or loads.shape[0] != num_layers:
                raise ValueError(
                    f"per-layer load matrix of shape {loads.shape}, expected "
                    f"({num_layers}, E)")
            s_pps = [self.observed_s_pp(
                         loads[j], ep_size,
                         placements[j] if placements is not None else None)
                     * (1.0 + headroom)
                     for j in range(num_layers)]
        out = []
        for j, s_pp in enumerate(s_pps):
            cand = self._schedule_for(s_pp, max_depth)
            if current is not None and j < len(current):
                inc = ScheduleSpec(*current[j])
                if cand != inc and self._admissible(inc, s_pp) and (
                        hysteresis > 0.0
                        and self._schedule_for(s_pp * (1.0 + hysteresis),
                                               max_depth) != cand):
                    cand = inc           # inside the hysteresis band: hold
            out.append(cand)
        self.history.append({"s_pp": s_pps, "layer_schedules": tuple(out)})
        return tuple(out)

    # -- reporting -------------------------------------------------------------
    def memory_report(self, s_pp: float, chunks: int,
                      pipeline_depth: int = 1) -> dict:
        act = mm.activation_bytes(self.dims, self.seq_len, s_pp, self.par,
                                  copies=self.copies, chunks=chunks,
                                  dtype_bytes=self.dtype_bytes,
                                  pipeline_depth=pipeline_depth,
                                  fused=self.fused)
        return {
            "static_gb": self.static / 2**30,
            "activation_gb": act / 2**30,
            "total_gb": (self.static + act) / 2**30,
            "fits": mm.fits(self.static, act, self.hw),
            "s_prime_max": self.s_prime_max(),
            "chunks": chunks,
            "pipeline_depth": pipeline_depth,
        }
