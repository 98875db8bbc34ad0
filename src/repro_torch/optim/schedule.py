"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""

from __future__ import annotations

import math


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``, flat after it."""
    step = float(step)
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                   0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))
