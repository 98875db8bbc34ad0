"""The program's span recorder (``repro_torch/runtime/spans.py``) as the
per-layer readers see it, and its join with the traced window.

The recorder stamps its spans with ``time.time_ns()``, the epoch clock on
which the profiler stamps the window's device activities, so a device idle
gap of ``Window.busy_intervals()`` is placed by its midpoint among the
spans that cover it, across threads (the backward and its recomputes run
on autograd's device thread).  A gap belongs to the shortest span covering
its midpoint, the rule ``trace.py`` applies to host operators.  The
trace's device stamps can stand up to a few ms off its host stamps early
in a window, so a gap that short at a span's edge can go to its
neighbour.

A program without the recorder (or one that recorded nothing in the
window) gives None, and every reader then returns None.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

OUTSIDE = "(outside any span)"


def recorded(run):
    """(span records, counters) of the window, or None where the program
    has no recorder or it holds nothing.  Read once per run."""
    cached = getattr(run, "_spans_recorded", False)
    if cached is not False:
        return cached
    try:
        from repro_torch.runtime import spans
    except ImportError:
        out = None
    else:
        recs, counts = spans.records(), spans.counters()
        out = (recs, counts) if recs or counts else None
    run._spans_recorded = out
    return out


def per_step(run, value):
    """``value`` over the window's steps; None without steps."""
    steps = run.record.get("steps")
    if value is None or not steps:
        return None
    return value / len(steps)


def device_ms(run, names) -> float | None:
    """Device milliseconds of the spans named in ``names``, per step."""
    got = recorded(run)
    if got is None:
        return None
    ms = [r.device_ms for r in got[0] if r.name in names and r.device_ms is not None]
    return per_step(run, sum(ms)) if ms else None


def gaps(window) -> list:
    """[(midpoint ns, length ns)] of the device's idle gaps in the window,
    by midpoint."""
    busy = window.busy_intervals()
    return sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                  for a, b in zip(busy, busy[1:]) if b[0] > a[1])


def covering(window, recs) -> list:
    """[(length ns, [spans covering the gap's midpoint])] for every idle
    gap of ``window``, over the span records ``recs``."""
    spans = sorted(recs, key=lambda r: r.start_ns)
    out, live, i = [], [], 0                  # heap of (end, id, record)
    for mid, length in gaps(window):
        while i < len(spans) and spans[i].start_ns <= mid:
            heapq.heappush(live, (spans[i].end_ns, spans[i].id, spans[i]))
            i += 1
        while live and live[0][0] < mid:
            heapq.heappop(live)
        out.append((length, [r for _, _, r in live]))
    return out


def owner(cover: list):
    """The shortest of the spans covering a gap, or None."""
    return min(cover, key=lambda r: r.end_ns - r.start_ns) if cover else None


def idle_ms(run, where) -> float | None:
    """Milliseconds per step of the gaps whose covering spans ``where``
    accepts."""
    got = recorded(run)
    if got is None or not run.window.device:
        return None
    ns = sum(length for length, cover in covering(run.window, got[0]) if where(cover))
    return per_step(run, ns / 1e6)


def idle_split(window, recs) -> dict:
    """{span name: idle seconds} of the window's gaps, each to the span that
    owns it (``OUTSIDE`` for none), the longest first."""
    by = defaultdict(int)
    for length, cover in covering(window, recs):
        o = owner(cover)
        by[o.name if o is not None else OUTSIDE] += length
    return {n: v / 1e9 for n, v in sorted(by.items(), key=lambda kv: -kv[1])}
