"""Online expert-load telemetry for adaptive MACT and expert placement.

``transformer.forward`` reports ``load_per_layer``, the (L_moe, E) matrix of
each MoE layer's routed token-slots per expert for the step.  This module
keeps the host's running view of that stream: a per-layer exponential
moving average, which ``MACTController.choose_layer_schedules`` reads at
each re-plan to resolve one (chunk bin, pipeline depth) per MoE layer, and
which ``core/placement.py::choose_placements`` reads to move hot experts.

Tiny numpy on the host: O(L_moe * E) floats per step, read from the
metrics the trainer already fetches.  The port's copy of the JAX package's
``LoadTelemetry``, choice for choice (serving's ``ExpertTelemetry`` is not
ported yet).
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
