"""The device trace of a ``--trace 1`` run, read from the profiler.

``Window`` wraps the measured window in ``torch.profiler`` (host and CUDA
activities) and, once it closes, reduces the raw Kineto events to what the
metric readers need: every device activity (kernels, copies, sets) as
(name, start, duration), the device's busy time (the union of those
intervals), and the idle gaps labelled by the host operation that spanned
them.  It sums the raw events, as ``chip_smoke.py::device_kernels`` does,
not ``key_averages()``, which first builds every host op's event tree in
Python (about 17 s per 200k events).
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict


class Window:
    """Context manager around the measured window; a no-op when off."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.device = []          # [(name, start_ns, dur_ns)]
        self.host = []            # [(name, start_ns, dur_ns)]
        self.window_s = 0.0

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.window_s = time.perf_counter() - self._t0
        if self.prof is None:
            return False
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType
        for e in self.prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns(), e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                if row[2] > 0:
                    self.device.append(row)
            elif row[2] > 0:
                self.host.append(row)
        self.prof = None
        return False

    # -- reductions -----------------------------------------------------------

    def busy_intervals(self) -> list:
        """The union of the device activities' intervals, sorted."""
        out = []
        for _, s, d in sorted(self.device, key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s + d)
            else:
                out.append([s, s + d])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_s_where(self, match) -> float:
        """Seconds of the device activities whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device if match(n)) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device activities that took most time."""
        by = defaultdict(int)
        for n, _, d in self.device:
            by[n] += d
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host op, seconds]]: the device's idle gaps inside the traced
        span, each named by the innermost host operation running at its
        midpoint, summed by name, the longest first."""
        busy = self.busy_intervals()
        gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                      for a, b in zip(busy, busy[1:]) if b[0] > a[1])
        host = sorted(self.host, key=lambda r: r[1])
        by = defaultdict(int)
        live, i = [], 0                       # heap of (end, -start, name)
        for mid, length in gaps:
            while i < len(host) and host[i][1] <= mid:
                n, s0, d = host[i]
                heapq.heappush(live, (s0 + d, -s0, n))
                i += 1
            while live and live[0][0] < mid:
                heapq.heappop(live)
            name = min(live, key=lambda r: r[1])[2] if live else "(no host op)"
            by[name] += length
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
