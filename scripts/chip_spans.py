#!/usr/bin/env python3
"""One traced run of a benchmark cell with the program's span recorder
joined to the device trace, on the card.

  python3 scripts/chip_spans.py --workload mixtral-train-s4k-b8-uniform \
      --seed 123456789 --seconds 51 --out DIR [--recorder off]

The run is ``perfbench/run.py --trace 1``'s (the same driver, window and
readers); ``--recorder off`` keeps the recorder off under the profiler
(``spans.enable(False)``), for its cost.  Besides the per-layer metrics it
writes, as one JSON file per run in ``--out`` and a summary line on
standard output:

* the traced window's tokens/s and its count of device activities;
* the idle time by the program span owning each gap (the shortest span
  covering its midpoint), and crossed with the host operator that
  ``perfbench/trace.py`` names the gap by;
* the share of idle time inside a ``train.step`` span, the device
  activities that begin outside every ``train.step`` span and the largest
  lead of one over the next step's start (the offset between the recorder's
  clock and the trace's), the smallest delay from a step's start to its
  first device activity and from a step's last device activity to the
  step's end (which ends in a sync): the bounds on that offset;
* per step, each span's count, host ms and device ms (and the threads it
  ran on), and the counters;
* whether a span's name appears among the device activities' names;
* bounds on the offset of the trace's device stamps from its host stamps
  (``clock_check``), over the window and its first and last fifths.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402


def host_labels(window, gaps) -> list:
    """The host operation ``trace.Window.idle_gaps`` names each gap by."""
    host = sorted(window.host, key=lambda r: r[1])
    out, live, i = [], [], 0
    for mid, _ in gaps:
        while i < len(host) and host[i][1] <= mid:
            n, s0, d = host[i]
            heapq.heappush(live, (s0 + d, -s0, n))
            i += 1
        while live and live[0][0] < mid:
            heapq.heappop(live)
        out.append(min(live, key=lambda r: r[1])[2] if live else "(no host op)")
    return out


class ClockWindow:
    """``trace.Window`` that also keeps, from the same session, each CUDA
    runtime call and each device activity with its correlation id."""

    @staticmethod
    def make(Window):
        class _W(Window):
            def __exit__(self, *exc):
                prof = self.prof
                out = super().__exit__(*exc)
                self.runtime, self.launched = [], []
                if prof is None or exc[0] is not None:
                    return out
                from torch.autograd import DeviceType
                for e in prof.profiler.kineto_results.events():
                    row = (e.correlation_id(), e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.name())
                    if e.device_type() == DeviceType.CUDA:
                        self.launched.append(row)
                    elif e.name().startswith("cuda"):
                        self.runtime.append(row)
                return out
        return _W(True)


def clock_check(window) -> dict:
    """Bounds on the device stamps' offset from the host's: an activity
    cannot begin before the runtime call that launched it (``early``: how
    far before it the trace puts one), nor end after the next stream sync
    that waited for it returned (``late``); each over the window and over
    its first and last fifths, in ms."""
    calls = {c: (s, e) for c, s, e, _ in window.runtime}
    syncs = sorted((s, e) for _, s, e, n in window.runtime if n == "cudaStreamSynchronize")
    starts = [s for s, _ in syncs]
    if not window.launched:
        return {}
    t0 = min(s for _, s, _, _ in window.launched)
    t1 = max(e for _, _, e, _ in window.launched)
    fifth = (t1 - t0) / 5
    parts = {"all": (t0, t1), "first_fifth": (t0, t0 + fifth), "last_fifth": (t1 - fifth, t1)}
    early = {k: None for k in parts}
    late = {k: None for k in parts}
    for c, s, e, _ in window.launched:
        if c not in calls:
            continue
        ls = calls[c][0]
        i = bisect.bisect_left(starts, calls[c][1])
        for k, (a, b) in parts.items():
            if not a <= s <= b:
                continue
            early[k] = max(early[k] if early[k] is not None else -1e18, ls - s)
            if i < len(syncs):
                late[k] = max(late[k] if late[k] is not None else -1e18, e - syncs[i][1])
    ms = lambda v: None if v is None else v / 1e6  # noqa: E731
    return {"early_ms": {k: ms(v) for k, v in early.items()},
            "late_ms": {k: ms(v) for k, v in late.items()},
            "pairs": sum(1 for c, *_ in window.launched if c in calls)}


def analyse(window, recs, counts, n_steps) -> dict:
    from perfbench import spans_join
    gaps = spans_join.gaps(window)
    cover = spans_join.covering(window, recs)
    labels = host_labels(window, gaps)
    idle_ns = sum(g for _, g in gaps)
    in_step = sum(length for length, c in cover if any(r.name == "train.step" for r in c))
    cross = defaultdict(lambda: defaultdict(int))
    for (length, c), label in zip(cover, labels):
        o = spans_join.owner(c)
        cross[label][o.name if o is not None else spans_join.OUTSIDE] += length
    top = sorted(cross, key=lambda k: -sum(cross[k].values()))[:10]
    steps = sorted((r.start_ns, r.end_ns) for r in recs if r.name == "train.step")
    starts = [s for s, _ in steps]
    outside, lead, first, last, early = 0, 0, {}, {}, defaultdict(int)
    for name, s, d in window.device:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= steps[i][1]:
            first[i] = min(first.get(i, s), s)
            last[i] = max(last.get(i, s + d), s + d)
            continue
        outside += 1
        early[name[:60]] += 1
        if i + 1 < len(steps):
            lead = max(lead, starts[i + 1] - s)
    delay = min((first[i] - starts[i] for i in first), default=None)
    margin = min((steps[i][1] - last[i] for i in last), default=None)
    by = defaultdict(lambda: [0, 0, 0.0, set()])
    for r in recs:
        b = by[r.name]
        b[0] += 1
        b[1] += r.end_ns - r.start_ns
        b[2] += r.device_ms or 0.0
        b[3].add(r.thread)
    names = {r.name for r in recs}
    return {
        "device_activities": len(window.device),
        "idle_s": idle_ns / 1e9,
        "idle_in_train_step_share": in_step / idle_ns if idle_ns else None,
        "idle_by_span_s": spans_join.idle_split(window, recs),
        "idle_by_host_op_and_span_s": {k: {n: v / 1e9 for n, v in sorted(
            cross[k].items(), key=lambda kv: -kv[1])} for k in top},
        "activities_outside_steps": outside,
        "outside_by_name": dict(sorted(early.items(), key=lambda kv: -kv[1])[:10]),
        "largest_lead_ms": lead / 1e6,
        "least_delay_to_first_activity_ms": None if delay is None else delay / 1e6,
        "least_margin_after_last_activity_ms": None if margin is None else margin / 1e6,
        "spans_per_step": {n: {"count": b[0] / n_steps, "host_ms": b[1] / 1e6 / n_steps,
                               "device_ms": b[2] / n_steps, "threads": len(b[3])}
                           for n, b in sorted(by.items())},
        "counters_per_step": {k: v / n_steps for k, v in counts.items()},
        "span_names_among_device_ops": sorted(names & {n for n, _, _ in window.device}),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", choices=("on", "off"), default="on")
    ap.add_argument("--out", required=True, help="directory for the JSON file")
    args = ap.parse_args()
    bench._environment()
    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    cell = bench.Cell(spec, args.workload, args.seed, args.seconds, True)
    import torch

    from perfbench import check
    from perfbench.trace import Window
    from repro_torch.runtime import spans
    torch.cuda.set_device(0)
    cell.program_config()
    if args.recorder == "off":
        spans.enable(False)
    window = ClockWindow.make(Window)
    out = cell.driver().run(cell, window)
    record = out["record"]
    n = len(record["steps"])
    line = {"workload": args.workload, "seed": args.seed, "recorder": args.recorder,
            "card": bench.power_limit(), "steps": n, "window_s": window.window_s,
            "traced_tokens_per_s": record["tokens"] / window.window_s,
            "busy_s": window.busy_s(),
            "metrics": {k: v["value"] for k, v in bench.read_per_layer(
                spec, cell, bench.RunView(cell, record, window)).items()},
            "correct": check.judge(out["readings"], cell.limits)[0]}
    line.update(analyse(window, spans.records(), spans.counters(), n))
    line["clocks"] = clock_check(window)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{args.workload}.{args.seed}.{args.recorder}.json").write_text(
        json.dumps(line, indent=1))
    keep = ("workload", "seed", "recorder", "steps", "window_s", "traced_tokens_per_s",
            "device_activities", "idle_in_train_step_share", "activities_outside_steps",
            "largest_lead_ms", "least_delay_to_first_activity_ms",
            "least_margin_after_last_activity_ms", "clocks", "metrics",
            "span_names_among_device_ops", "card")
    print(json.dumps({k: line[k] for k in keep}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
