"""Deterministic fault injection for the resilience runtime.

MemFine plans memory for a *predicted* routed load (Eq. 8-9); production is
where the prediction is wrong: a skew burst past the planned s'', a real
out-of-memory error from the allocator, a crash mid-step, a checkpoint cut
short by a dying host.  The ``FaultInjector`` reproduces exactly those
failures on demand, so the degradation ladder (runtime/guard.py) and the
resume path (training/trainer.py) are testable on the CPU.  The port's copy
of the JAX package's ``runtime/faults.py``, kind for kind.

Fault kinds (``FaultSpec.kind``):

* ``oom``           -- raise ``SimulatedOOM`` (a ``MemoryError`` that reads
                       like the allocator's message) before the step runs.
* ``burst``         -- multiply the observed router load by ``magnitude``
                       before it feeds back to MACT: a routing skew burst
                       beyond the planned s''.
* ``crash``         -- raise ``SimulatedCrash``: a hard process death the
                       guard must NOT swallow (the resume path handles it).
* ``stall``         -- sleep ``magnitude`` seconds (a straggler step).
* ``ckpt_truncate`` -- truncate the newest checkpoint payload on disk, the
                       torn write a crash-consistent store must survive.

Each spec fires at ``at`` (a training step index) for ``times`` consecutive
triggers.  Everything fired is recorded in ``injector.fired``.  Under a mesh
every rank parses the same spec, so an injected fault fires on every rank at
the same step.
"""

from __future__ import annotations

import glob
import os
import time
from dataclasses import dataclass, field
from typing import Optional


class SimulatedOOM(MemoryError):
    """Stands in for the allocator's out-of-memory error."""

    def __init__(self, where: str = "step"):
        super().__init__(f"RESOURCE_EXHAUSTED: simulated out of memory "
                         f"while running {where}")


class SimulatedCrash(RuntimeError):
    """A hard failure the guard must re-raise (process death, not OOM)."""


@dataclass
class FaultSpec:
    kind: str                  # oom | burst | crash | stall | ckpt_truncate
    at: int                    # step index the fault arms at
    times: int = 1             # consecutive triggers before it disarms
    magnitude: float = 2.0     # burst load multiplier / stall seconds
    fired: int = 0             # how often this spec has gone off

    _KINDS = ("oom", "burst", "crash", "stall", "ckpt_truncate")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self._KINDS}")

    def armed(self, step: int) -> bool:
        return step >= self.at and self.fired < self.times


def parse_spec(text: str) -> list[FaultSpec]:
    """``"oom@3,burst@2x1.5,ckpt_truncate@4"`` -> FaultSpec list.

    Grammar per item: ``kind@step[xMAGNITUDE][*TIMES]``, the form of
    ``launch/train.py --inject``.
    """
    specs = []
    for item in filter(None, (s.strip() for s in text.split(","))):
        kind, _, rest = item.partition("@")
        if not rest:
            raise ValueError(f"fault spec {item!r} needs '@step'")
        times = 1
        if "*" in rest:
            rest, _, t = rest.partition("*")
            times = int(t)
        magnitude = 2.0
        if "x" in rest:
            rest, _, m = rest.partition("x")
            magnitude = float(m)
        specs.append(FaultSpec(kind=kind, at=int(rest), times=times,
                               magnitude=magnitude))
    return specs


@dataclass
class FaultInjector:
    """Threaded through ``Trainer.fit``.  Every hook is a no-op unless a
    matching spec is armed for the current step, so a ``None`` injector and
    an empty one behave identically."""
    specs: list = field(default_factory=list)
    fired: list = field(default_factory=list)   # (kind, step) audit trail

    @classmethod
    def from_string(cls, text: str) -> "FaultInjector":
        return cls(specs=parse_spec(text))

    def _take(self, kind: str, step: int):
        for spec in self.specs:
            if spec.kind == kind and spec.armed(step):
                spec.fired += 1
                self.fired.append((kind, step))
                return spec
        return None

    # -- hooks ---------------------------------------------------------------

    def maybe_fail_step(self, step: int, where: str = "train_step") -> None:
        """Raise the armed failure for ``step`` (OOM before crash: a run
        with both scheduled at one step must exercise the ladder first)."""
        if self._take("oom", step) is not None:
            raise SimulatedOOM(where)
        if self._take("crash", step) is not None:
            raise SimulatedCrash(f"simulated crash at {where} step {step}")

    def maybe_stall(self, step: int) -> float:
        spec = self._take("stall", step)
        if spec is not None:
            time.sleep(spec.magnitude)
            return spec.magnitude
        return 0.0

    def burst_factor(self, step: int) -> float:
        """Routing-burst multiplier for this step's observed load (1.0 when
        nothing is armed)."""
        spec = self._take("burst", step)
        return 1.0 if spec is None else float(spec.magnitude)

    def maybe_truncate_checkpoint(self, step: int, ckpt_dir: str,
                                  rank: Optional[int] = None) -> Optional[str]:
        """Tear the newest checkpoint payload in half -- the torn write of a
        host dying mid-save.  Under a mesh (``rank`` given) only this rank's
        own payload.  Returns the mangled path, or None."""
        spec = self._take("ckpt_truncate", step)
        if spec is None or not ckpt_dir:
            return None
        pattern = "step_*.npz" if rank is None else f"step_*.rank{rank}.npz"
        payloads = sorted(glob.glob(os.path.join(ckpt_dir, pattern)))
        if not payloads:
            return None
        victim = payloads[-1]
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(size // 2)
        return victim
