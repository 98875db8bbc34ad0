"""Serving overload guard and out-of-memory classification.

``ServingGuard`` holds the scheduler-side policy: the per-request admission
deadline, the WAITING-queue overload bound, and the retry-after estimate
quoted to shed clients.  Accepted requests are never shed; shedding applies
only to requests still waiting for admission.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


def is_oom_error(exc: BaseException) -> bool:
    """Is ``exc`` an out-of-memory failure the scheduler should absorb?"""
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    return "out of memory" in str(exc).lower()


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
