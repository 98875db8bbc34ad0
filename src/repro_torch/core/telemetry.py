"""Online expert-load telemetry for adaptive MACT and expert placement.

``transformer.forward`` reports ``load_per_layer``, the (L_moe, E) matrix of
each MoE layer's routed token-slots per expert for the step.  This module
keeps the host's running view of that stream: a per-layer exponential
moving average, which ``MACTController.choose_layer_schedules`` reads at
each re-plan to resolve one (chunk bin, pipeline depth) per MoE layer, and
which ``core/placement.py::choose_placements`` reads to move hot experts.

Tiny numpy on the host: O(L_moe * E) floats per step, read from the
metrics the trainer already fetches.  The port's copy of the JAX package's
``LoadTelemetry``, choice for choice.

``ExpertTelemetry`` is its serving twin: one EMA per resident request, which
the expert-aware scheduler (``serving/scheduler.py``) reads to group decode
waves by predicted expert overlap and to prefetch cold experts
(``serving/residency.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class LoadTelemetry:
    """Per-layer EMA of the routed-token histograms.

    ``decay`` is the EMA retention: ``ema <- decay * ema + (1-decay) * obs``.
    The first observation initialises the EMA directly (no zero-bias warmup:
    MACT must not under-plan memory while the average ramps)."""
    num_layers: int
    num_experts: int
    decay: float = 0.6
    steps: int = 0
    _ema: Optional[np.ndarray] = field(default=None, repr=False)

    def update(self, load_per_layer) -> np.ndarray:
        obs = np.asarray(load_per_layer, dtype=np.float64)
        if obs.shape != (self.num_layers, self.num_experts):
            raise ValueError(
                f"telemetry update of shape {obs.shape}, expected "
                f"({self.num_layers}, {self.num_experts})")
        if self._ema is None:
            self._ema = obs.copy()
        else:
            self._ema = self.decay * self._ema + (1.0 - self.decay) * obs
        self.steps += 1
        return self._ema

    @property
    def loads(self) -> Optional[np.ndarray]:
        """(L_moe, E) EMA load matrix, or None before the first update."""
        return None if self._ema is None else self._ema.copy()

    def imbalance(self) -> Optional[np.ndarray]:
        """(L_moe,) per-layer max/mean ratio of the EMA (1.0 = balanced),
        None before the first update; an all-zero layer reports 1.0."""
        if self._ema is None:
            return None
        mean = self._ema.mean(axis=1)
        peak = self._ema.max(axis=1)
        return np.where(mean > 0.0, peak / np.maximum(mean, 1e-30), 1.0)

    def reset(self) -> None:
        self._ema = None
        self.steps = 0

    # -- checkpoint round trip: a resumed run replans from the warm EMA -------
    def state_dict(self) -> dict:
        return {"steps": self.steps,
                "ema": None if self._ema is None else self._ema.tolist()}

    def load_state_dict(self, state: dict) -> None:
        # validate before assigning: a failed restore leaves the live EMA
        # and step count as they were
        ema = state.get("ema")
        restored = None if ema is None else np.asarray(ema, dtype=np.float64)
        if restored is not None and restored.shape != (self.num_layers,
                                                       self.num_experts):
            raise ValueError(
                f"restored telemetry EMA of shape {restored.shape}, expected "
                f"({self.num_layers}, {self.num_experts})")
        self.steps = int(state.get("steps", 0))
        self._ema = restored


@dataclass
class ExpertTelemetry:
    """Per-REQUEST EMA of the per-MoE-layer activated-expert histograms.

    The serving-side twin of ``LoadTelemetry``: where the trainer keeps one
    EMA per layer over the whole batch, the expert-aware scheduler keeps one
    ``(L_moe, E)`` EMA per *resident request*, fed from the load rows its
    prefill chunks and decode steps report.  Wave formation reads ``support``/``expert_set`` to group
    requests by predicted expert overlap, and the residency tier reads the
    per-layer union to prefetch cold experts ahead of the wave.

    ``support_rel`` prunes the prediction: an expert whose EMA weight has
    decayed below that fraction of the request's hottest entry is dropped
    from the predicted set (a pure-EMA support would grow monotonically —
    every expert ever activated stays > 0 forever under float decay).
    """
    num_layers: int
    num_experts: int
    decay: float = 0.5
    support_rel: float = 0.02
    _ema: dict = field(default_factory=dict, repr=False)   # rid -> (L_moe, E)

    def update(self, rid: int, load_per_layer) -> np.ndarray:
        obs = np.asarray(load_per_layer, dtype=np.float64)
        if obs.shape != (self.num_layers, self.num_experts):
            raise ValueError(
                f"expert telemetry update of shape {obs.shape}, expected "
                f"({self.num_layers}, {self.num_experts})")
        prev = self._ema.get(rid)
        if prev is None:
            self._ema[rid] = obs.copy()
        else:
            self._ema[rid] = self.decay * prev + (1.0 - self.decay) * obs
        return self._ema[rid]

    def loads(self, rid: int) -> Optional[np.ndarray]:
        ema = self._ema.get(rid)
        return None if ema is None else ema.copy()

    def support(self, rid: int) -> Optional[np.ndarray]:
        """(L_moe, E) bool predicted-activation mask, or None before the
        first observation for this request."""
        ema = self._ema.get(rid)
        if ema is None:
            return None
        return ema > self.support_rel * max(float(ema.max()), 1e-30)

    def expert_set(self, rid: int) -> frozenset:
        """Predicted activated expert ids, unioned over layers (what the
        greedy wave grouping minimises the union of).  Empty for unseen
        requests — they cost nothing to add to any wave."""
        sup = self.support(rid)
        if sup is None:
            return frozenset()
        return frozenset(int(e) for e in np.flatnonzero(sup.any(axis=0)))

    def forget(self, rid: int) -> None:
        self._ema.pop(rid, None)

    def clear(self) -> None:
        self._ema.clear()
