"""Expert-weight residency tier: cold experts offloaded to the host, streamed
back ahead of the decode wave that needs them.

Decode is bound by the bytes of the expert weights it reads, so only a
per-MoE-layer resident set of expert FFN weights (w1/w3/w2) is meant to stay
on the device.  Every other expert's device rows are zeroed; its bits live
in a permanent host mirror taken at construction, so a restore is bitwise.
The telemetry-predicted set of the next wave is prefetched; an expert the
wave activates that the prediction missed is restored on demand and the run
is re-issued (the scheduler's ``_demand_fixpoint``), so outputs are
bit-identical to the all-resident engine:

* a run in which every *activated* expert held its true weights equals the
  all-resident run bit for bit: an expert no token routed to contributes
  nothing, so zeroed cold rows are unobservable;
* a run with a miss is thrown away, the missing experts are restored and
  the run is re-issued from its pre-run state.  Layer-0 routing depends on
  dense weights only, so each re-run fixes a strictly longer correct prefix
  of MoE layers; the loop converges in at most L_moe * E runs.

Eviction is by a heat EMA over the observed per-layer loads, never touches
the always-resident set (the experts a build-time placement replicated) and
runs after the wave: capacity is a target the memory model prices, and
demand restores above it show in the high-water mark.

The port's counterpart of the JAX package's ``serving/residency.py``, with
one deliberate difference: the reference updates its params functionally
and the scheduler rebinds them, while here every offload and restore writes
the caller's expert tensors **in place** (``zero_`` and ``copy_`` of the
expert's rows, on the current stream, which the compiled steps replay on).
A CUDA graph bakes in its weights' pointers (``serving/engine.py``), so a
new tensor per restore would capture a new graph at every restore.  In
place, every weight keeps its ``data_ptr``, and schedulers that share one
``params`` would see each other's offloads: ``restore_all`` (which the
scheduler's ``close`` calls) hands the weights back whole, and a tier
refuses to open on expert tensors that another open tier writes (its
mirror would take that tier's zeroed rows for the true bits).  The mirror is
pinned host memory on the card (a failure to pin raises), plain CPU tensors
on the CPU; it is released with the residency.

The device keeps the whole expert table allocated: offloading changes what
admission models, not what the card holds.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.configs.base import ModelConfig

#: expert FFN leaves the tier streams (router weights are always resident)
EXPERT_LEAVES = ("w1", "w3", "w2")

#: demand-restore loop bound (convergence is <= L_moe * E)
RERUN_LIMIT = 64

#: weight of the old heat in the eviction EMA (the reference's default)
HEAT_DECAY = 0.6

#: each MoE layer's ``w1`` -> the open tier that writes it in place
_HOLDERS = WeakTensorKeyDictionary()


def moe_layer_refs(cfg: ModelConfig) -> List[int]:
    """Index in ``params["layers"]`` of every MoE layer, in
    ``load_per_layer`` order.  The port's layers are one flat list, so a
    ref is the flat index where the JAX package's is ``(head, index,
    period)``; ``bridge.layers_in_order`` maps one onto the other."""
    return [i for i, spec in enumerate(cfg.layer_specs()) if spec.ffn == "moe"]


def always_resident_sets(placements, num_layers: int,
                         num_experts: int) -> List[frozenset]:
    """Per-MoE-layer expert ids the tier must never offload: the experts the
    build-time placement replicated across peers (a replica on another peer
    is useless once the canonical weights left the device)."""
    if placements is None:
        return [frozenset()] * num_layers
    if len(placements) != num_layers:
        raise ValueError(f"{len(placements)} placements for {num_layers} "
                         "MoE layers")
    out = []
    for spec in placements:
        if spec is None:
            out.append(frozenset())
            continue
        counts = spec.replica_counts()
        out.append(frozenset(int(e) for e in np.flatnonzero(counts > 1)))
    return out


def _mirror(w: torch.Tensor) -> torch.Tensor:
    """A host copy of ``w``: pinned when ``w`` is on the card."""
    if w.device.type != "cuda":
        return w.detach().clone()
    host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
    host.copy_(w)
    return host


class ExpertResidency:
    """Per-layer resident-set manager over the model's expert weights.

    Every method that moves weights takes ``params`` and writes its expert
    tensors in place (module docstring); the manager keeps the host mirror,
    the resident sets, the heat EMA and the transfer counters."""

    def __init__(self, params: dict, cfg: ModelConfig, capacity: int, *,
                 always_resident: Optional[Sequence[frozenset]] = None):
        if cfg.moe is None:
            raise ValueError("expert residency needs a MoE config")
        self.cfg = cfg
        self.refs = moe_layer_refs(cfg)
        self.num_layers = len(self.refs)
        self.num_experts = cfg.moe.num_experts
        if not 1 <= capacity <= self.num_experts:
            raise ValueError(f"resident capacity {capacity} outside "
                             f"[1, {self.num_experts}]")
        self.capacity = capacity
        self.always = (list(always_resident) if always_resident is not None
                       else [frozenset()] * self.num_layers)
        if len(self.always) != self.num_layers:
            raise ValueError(f"{len(self.always)} always-resident sets for "
                             f"{self.num_layers} MoE layers")
        for j, a in enumerate(self.always):
            if len(a) > capacity:
                raise ValueError(
                    f"layer {j}: {len(a)} always-resident (replicated) "
                    f"experts exceed capacity {capacity}")
        keys = [self._ffn(params, j)["w1"] for j in range(self.num_layers)]
        if any(_HOLDERS.get(w) is not None for w in keys):
            raise RuntimeError("another open expert-residency tier writes these "
                               "expert weights in place: close its scheduler "
                               "first")
        # the permanent host mirror: the construction-time bits of every
        # expert's FFN leaves; restores copy from it bit for bit
        t0 = time.perf_counter()
        self.host: List[dict] = [
            {name: _mirror(self._ffn(params, j)[name]) for name in EXPERT_LEAVES}
            for j in range(self.num_layers)]
        self.mirror_s = time.perf_counter() - t0
        self.mirror_bytes = sum(t.numel() * t.element_size()
                                for leaves in self.host for t in leaves.values())
        self.resident: List[set] = [set(range(self.num_experts))
                                    for _ in range(self.num_layers)]
        self.heat = np.zeros((self.num_layers, self.num_experts))
        self.reset_stats()
        for w in keys:
            _HOLDERS[w] = self

    def _ffn(self, params: dict, layer: int) -> dict:
        return params["layers"][self.refs[layer]]["ffn"]

    # -- accounting ----------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the transfer counters; the high-watermark restarts at the
        resident sets' largest."""
        self.restores = 0          # expert-layer rows streamed host -> device
        self.offloads = 0          # expert-layer rows zeroed on the device
        self.demand_restores = 0   # restores a run had to wait for (misses)
        self.hwm_experts = max(len(s) for s in self.resident)

    def stats(self) -> dict:
        return {"restores": self.restores, "offloads": self.offloads,
                "demand_restores": self.demand_restores,
                "resident_experts_hwm": self.hwm_experts}

    def resident_counts(self) -> np.ndarray:
        return np.asarray([len(s) for s in self.resident], np.int64)

    def _note_hwm(self) -> None:
        self.hwm_experts = max(self.hwm_experts,
                               max(len(s) for s in self.resident))

    # -- heat ----------------------------------------------------------------

    def note(self, load_per_layer) -> None:
        """Fold an observed (L_moe, E) load matrix into the heat EMA, the
        eviction policy's frequency signal."""
        obs = np.asarray(load_per_layer, dtype=np.float64)
        if obs.shape != self.heat.shape:
            raise ValueError(f"load of shape {obs.shape}, expected "
                             f"{self.heat.shape}")
        self.heat = HEAT_DECAY * self.heat + (1 - HEAT_DECAY) * obs

    # -- tier transitions ----------------------------------------------------

    def offload_cold(self, params: dict) -> None:
        """Initial tiering: keep the always-resident experts plus the
        lowest-id fillers up to capacity per layer; zero every other
        expert's device rows."""
        for j in range(self.num_layers):
            keep = set(self.always[j])
            for e in range(self.num_experts):
                if len(keep) >= self.capacity:
                    break
                keep.add(e)
            drop = set(range(self.num_experts)) - keep
            self._apply(params, j, drop, restore=False)
            self.resident[j] = keep
            self.offloads += len(drop)
        self.hwm_experts = max(len(s) for s in self.resident)

    def missing(self, active: np.ndarray) -> List[Tuple[int, int]]:
        """(layer, expert) pairs an (L_moe, E) bool activation matrix hits
        that are not resident: what a run must restore before its members'
        math is trustworthy."""
        act = np.asarray(active)
        if act.shape != (self.num_layers, self.num_experts):
            raise ValueError(f"activation of shape {act.shape}, expected "
                             f"({self.num_layers}, {self.num_experts})")
        return [(j, int(e)) for j in range(self.num_layers)
                for e in np.flatnonzero(act[j])
                if int(e) not in self.resident[j]]

    def ensure(self, params: dict, pairs: Iterable[Tuple[int, int]], *,
               demand: bool = False) -> None:
        """Restore the given (layer, expert) pairs from the host mirror."""
        by_layer: dict = {}
        for j, e in pairs:
            if e not in self.resident[j]:
                by_layer.setdefault(j, set()).add(e)
        for j, experts in by_layer.items():
            self._apply(params, j, experts, restore=True)
            self.resident[j] |= experts
            self.restores += len(experts)
            if demand:
                self.demand_restores += len(experts)
        self._note_hwm()

    def prefetch(self, params: dict, predicted: np.ndarray) -> None:
        """Stream the predicted set of the imminent wave: restore predicted
        cold experts, then evict back toward capacity while protecting the
        prediction."""
        pred = np.asarray(predicted)
        pairs = [(j, int(e)) for j in range(self.num_layers)
                 for e in np.flatnonzero(pred[j])]
        self.ensure(params, pairs)
        keep = [frozenset(int(e) for e in np.flatnonzero(pred[j]))
                | self.always[j] for j in range(self.num_layers)]
        self.evict_to_capacity(params, protect=keep)

    def evict_to_capacity(self, params: dict,
                          protect: Optional[Sequence[frozenset]] = None) -> None:
        """Zero the coldest (heat EMA) evictable experts above capacity per
        layer.  ``protect`` shields a per-layer set beyond the always-
        resident experts; a layer whose protected set exceeds capacity
        stays over target (the high-water mark reports it)."""
        for j in range(self.num_layers):
            shield = set(self.always[j])
            if protect is not None:
                shield |= set(protect[j])
            over = len(self.resident[j]) - self.capacity
            if over <= 0:
                continue
            cands = sorted(self.resident[j] - shield,
                           key=lambda e: (self.heat[j, e], e))
            drop = set(cands[:over])
            if drop:
                self._apply(params, j, drop, restore=False)
                self.resident[j] -= drop
                self.offloads += len(drop)

    def restore_all(self, params: dict) -> None:
        """Hand the weights back whole: every offloaded expert restored from
        the mirror.  Teardown (``close``), so no counter moves."""
        for j in range(self.num_layers):
            cold = set(range(self.num_experts)) - self.resident[j]
            self._apply(params, j, cold, restore=True)
            self.resident[j] = set(range(self.num_experts))

    def close(self, params: dict) -> None:
        """``restore_all``, then release the host mirror and the weights for
        another tier; the counters stay readable.  Idempotent."""
        if self.host is not None:
            self.restore_all(params)
            self.host = None
            for j in range(self.num_layers):
                w = self._ffn(params, j)["w1"]
                if _HOLDERS.get(w) is self:
                    del _HOLDERS[w]

    def _apply(self, params: dict, layer: int, experts: set,
               restore: bool) -> None:
        """Write one layer's expert rows in place: the mirror's bits on
        restore, zeros on offload."""
        if not experts:
            return
        ffn = self._ffn(params, layer)
        with torch.no_grad():
            for name in EXPERT_LEAVES:
                w = ffn[name]
                for e in sorted(experts):
                    if restore:
                        w[e].copy_(self.host[layer][name][e], non_blocking=True)
                    else:
                        w[e].zero_()
