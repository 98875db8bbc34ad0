"""The OOM degradation ladder, the serving overload guard, and
out-of-memory classification.

MemFine's memory model *plans* a schedule that should fit; this module is
what happens when the plan is wrong anyway.

Training -- ``OOMGuard`` wraps the trainer's step.  An out-of-memory failure
(a real ``torch.cuda.OutOfMemoryError`` or an injected ``SimulatedOOM``)
does not kill the run: the guard releases the failed attempt and retries
down a **degradation ladder** of strictly more memory-conservative schedules
drawn from ``MACTController.schedule_space``:

    incumbent (bin, depth)
      -> same bin, depth 1        (drop the pipeline's extra live chunk)
      -> each larger bin, depth 1 (deeper FCDA chunking, Eq. 9)
      -> largest bin, depth 1, remat_policy="full"  (full recompute)

Retries are bounded by ``max_retries``; exhausting the ladder raises, so an
impossible step fails loudly instead of looping.  Every escalation is
recorded, and the trainer audits the memory model through ``on_oom``.

The JAX package's step is functional, so its input state is the rollback
point.  The port's step updates the state in place, and its rollback point
is the step's transaction (``training/step.py``): nothing of the state is
written until every allocation of the step has succeeded, so a failed
attempt leaves the state as it found it.

Under a mesh of more than one rank (``rank`` set) only faults that every
rank sees can be walked: an injected fault fires on every rank at the same
step, so the ranks walk the ladder in lockstep.  A real OOM strikes one
rank and leaves its peers blocked inside a collective, which no in-process
retry can resynchronise; it is re-raised with the rank named, and recovery
is the resume path.  (The JAX package runs one controller, which sees every
failure.)

Serving -- ``ServingGuard`` holds the scheduler-side policy: the
per-request admission deadline, the WAITING-queue overload bound, and the
retry-after estimate quoted to shed clients.  Accepted requests are never
shed; shedding applies only to requests still waiting for admission.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.core.chunking import ScheduleSpec
from repro_torch.runtime.faults import SimulatedOOM

# the ladder's final rung: the trainer runs this key with
# remat_policy="full" on top of the largest chunk bin
FULL_REMAT = "full-remat"


def is_oom_error(exc: BaseException) -> bool:
    """Is ``exc`` an out-of-memory failure the ladder (or the serving
    scheduler) should absorb?  The injected ``SimulatedOOM``, the caching
    allocator's ``torch.cuda.OutOfMemoryError``, a host ``MemoryError``,
    and errors that carry an allocator's message."""
    if isinstance(exc, (SimulatedOOM, torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    msg = str(exc)
    return "RESOURCE_EXHAUSTED" in msg or "out of memory" in msg.lower()


def _conservatism(key: tuple) -> tuple:
    """(chunks, depth) summary of a schedule key, for ladder ordering: for
    adaptive MACT's per-layer vector, the least chunked and deepest of its
    layers' schedules (that is what runs out of memory first)."""
    if key and key[0] == FULL_REMAT:
        return (key[1], 1)
    if key and isinstance(key[0], tuple):                  # per-layer vector
        specs = [ScheduleSpec(*s) for s in key]
        return (min(s.chunks for s in specs), max(s.depth for s in specs))
    return (int(key[0]), int(key[1]))


@dataclass
class DegradationLadder:
    """Rungs strictly more memory-conservative than an incumbent key.
    ``space`` is ``MACTController.schedule_space(max_depth)``, so escalation
    never mints a schedule the controller could not emit."""
    space: tuple

    def rungs_after(self, key: tuple) -> list[tuple]:
        if key and key[0] == FULL_REMAT:
            return []                                      # already at the floor
        bins = sorted({ScheduleSpec(*s).chunks for s in self.space})
        c, d = _conservatism(key)
        rungs: list[tuple] = []
        if d > 1:
            rungs.append((c, 1))
        rungs += [(b, 1) for b in bins if b > c]
        rungs.append((FULL_REMAT, bins[-1]))
        return rungs


def _drop_frames(exc: BaseException) -> None:
    """Cut ``exc`` (and the exceptions it chains to) from the frames it
    was raised through.  A traceback holds the failed attempt's frames, and
    through their locals (the loss, the autograd graph) every activation
    the attempt saved: a retry that keeps them runs out of memory again."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _release() -> None:
    """Free what a failed attempt left: its reference cycles, then (on a
    card) the allocator's cached blocks, so that the failed attempt's
    fragments do not decide the retry."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


@dataclass
class OOMGuard:
    """Execute-with-ladder wrapper for the trainer's step."""
    ladder: DegradationLadder
    max_retries: int = 4
    on_oom: Optional[Callable] = None     # (key, exc, step) -> audit dict
    rank: Optional[int] = None            # this rank, under a mesh of > 1 rank
    escalations: list = field(default_factory=list)
    audits: list = field(default_factory=list)

    def run(self, key: tuple, attempt: Callable, step: int):
        """``attempt(key) -> result`` under the ladder.

        Returns ``(result, key_used)``.  Non-OOM exceptions (including
        ``SimulatedCrash``) propagate untouched: they are the resume path's
        job, not the ladder's.  Each failed attempt is released before the
        next rung runs."""
        rungs = [key] + self.ladder.rungs_after(key)
        last: Optional[BaseException] = None
        for retries, k in enumerate(rungs):
            if retries > self.max_retries:
                break
            if retries:
                _release()
            try:
                return attempt(k), k
            except Exception as exc:                  # noqa: BLE001 -- classified below
                if not is_oom_error(exc):
                    raise
                if self.rank is not None and not isinstance(exc, SimulatedOOM):
                    raise RuntimeError(
                        f"rank {self.rank} ran out of memory at step {step} on "
                        f"schedule {k!r}; its peers wait in a collective, so the "
                        f"ladder cannot retry under a mesh: resume from the last "
                        f"checkpoint") from exc
                _drop_frames(exc)
                last = exc
                nxt = rungs[retries + 1] if retries + 1 < len(rungs) else None
                self.escalations.append(
                    {"step": step, "failed": k, "next": nxt,
                     "retries": retries + 1, "error": str(exc)})
                if self.on_oom is not None:
                    audit = self.on_oom(k, exc, step)
                    if audit:
                        self.audits.append(audit)
        raise RuntimeError(
            f"OOM ladder exhausted at step {step}: "
            f"{min(len(rungs), self.max_retries + 1)} schedules failed, "
            f"last {self.escalations[-1]['failed']!r}") from last


@dataclass
class ServingGuard:
    """* ``deadline_s`` -- default admission deadline: a WAITING request not
      admitted within this many seconds of arrival is shed with a
      client-visible ``retry_after``.  Per-request deadlines override it.
    * ``max_waiting`` -- overload bound on the WAITING queue; arrivals
      beyond it are shed immediately (0 = unbounded).
    * ``retry_after`` -- the backlog drained at the observed request
      service rate, floored at one second."""
    deadline_s: Optional[float] = None
    max_waiting: int = 0

    def deadline_for(self, req) -> Optional[float]:
        return req.deadline_s if req.deadline_s is not None else self.deadline_s

    def expired(self, req, now: float) -> bool:
        dl = self.deadline_for(req)
        return dl is not None and (now - req.arrival) > dl

    def overloaded(self, waiting: int) -> bool:
        return self.max_waiting > 0 and waiting >= self.max_waiting

    def retry_after(self, backlog: int, service_rate_hz: float) -> float:
        if service_rate_hz <= 0:
            return max(1.0, float(backlog))
        return max(1.0, backlog / service_rate_hz)
