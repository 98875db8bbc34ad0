"""The readers of the program's spans (``perfbench/spans_join.py`` and six
metrics) on a synthetic window and synthetic span records: a gap goes to
the innermost span covering its midpoint, across threads, or to none;
values are per step; nothing recorded, or no recorder, reads None; and the
six metrics are found by name from ``BENCHMARK.json``, in the order it
lists them (metrics added later may follow them)."""

import json
import sys
from types import SimpleNamespace

import pytest

from perfbench import run, spans_join
from perfbench.trace import Window
from repro_torch.runtime import spans

NEW = ("attention_device_ms_per_step", "optimizer_device_ms_per_step",
       "recompute_device_ms_per_step", "fcda_chunk_runs_per_step",
       "idle_in_recompute_ms_per_step", "idle_in_trainer_ms_per_step")
CELLS = ["mixtral-train-s4k-b8-uniform", "mixtral-train-s4k-b2-uniform"]
MAIN, AUTOGRAD = 1, 2
MS = 1_000_000


def _rec(name, i, start, end, thread=MAIN, parent=None, device_ms=None):
    return spans.Record(name, i, parent, thread, start * MS, end * MS, device_ms)


# two steps of 100 ms (times in ms): the forward and optimizer on the main
# thread, the backward's attention and recompute on autograd's thread
RECORDS = [
    _rec("train.step", 0, 0, 100), _rec("train.plan", 1, 0, 5, parent=0),
    _rec("train.forward", 2, 5, 40, parent=0),
    _rec("attn", 3, 10, 20, parent=2, device_ms=8.0),
    _rec("train.backward", 4, 40, 80, parent=0),
    _rec("remat.layer", 5, 42, 50, AUTOGRAD, device_ms=6.0),
    _rec("attn", 6, 43, 46, AUTOGRAD, parent=5, device_ms=2.5),
    _rec("remat.chunk", 7, 52, 60, AUTOGRAD, device_ms=7.0),
    _rec("attn.bwd", 8, 62, 75, AUTOGRAD, device_ms=12.0),
    _rec("train.optimizer", 9, 80, 95, parent=0, device_ms=14.0),
    _rec("train.readback", 10, 95, 100, parent=0),
    _rec("train.step", 11, 110, 200),
    _rec("train.optimizer", 12, 180, 195, parent=11, device_ms=16.0),
]
COUNTS = {"fcda.chunk_runs": 88}
# device busy (ms); the gaps' midpoints: 3 (train.plan), 44.5 (attn inside
# remat.layer, on the autograd thread, inside train.backward on the main
# one), 56 (remat.chunk), 97.5 (train.readback), 105.5 (between the steps),
# 197.5 (train.step, after its optimizer)
BUSY = [(0, 2), (4, 44), (45, 55), (57, 95), (100, 101), (110, 195), (200, 210)]


def _window(busy=BUSY):
    w = Window(False)
    w.device = [("k", a * MS, (b - a) * MS) for a, b in busy]
    w.window_s = 0.21
    return w


@pytest.fixture
def recorder(monkeypatch):
    held = {"recs": RECORDS, "counts": COUNTS}
    monkeypatch.setattr(spans, "records", lambda: list(held["recs"]))
    monkeypatch.setattr(spans, "counters", lambda: dict(held["counts"]))
    return held


def _view(steps=2, window=None):
    return SimpleNamespace(record={"steps": [{}] * steps}, window=window or _window())


def _read(name, view):
    return run.load_module(run.HERE / "metrics" / f"{name}.py", "t_" + name).read(view)


def test_a_gap_goes_to_the_innermost_span_across_threads_or_to_none(recorder):
    split = spans_join.idle_split(_window(), RECORDS)
    assert split == pytest.approx({"train.plan": 2e-3, "attn": 1e-3, "remat.chunk": 2e-3,
                                   "train.readback": 5e-3, spans_join.OUTSIDE: 9e-3,
                                   "train.step": 5e-3})
    assert list(split)[0] == spans_join.OUTSIDE                 # longest first
    cover = dict(spans_join.covering(_window(), RECORDS))
    assert {r.name for r in cover[1 * MS]} == {"train.step", "train.backward",
                                               "remat.layer", "attn"}
    assert spans_join.owner(cover[1 * MS]).thread == AUTOGRAD
    assert spans_join.owner([]) is None


def test_the_readers_divide_by_the_window_s_steps(recorder):
    view = _view()
    assert _read("attention_device_ms_per_step", view) == pytest.approx((8 + 2.5 + 12) / 2)
    assert _read("optimizer_device_ms_per_step", view) == pytest.approx((14 + 16) / 2)
    assert _read("recompute_device_ms_per_step", view) == pytest.approx((6 + 7) / 2)
    assert _read("fcda_chunk_runs_per_step", view) == 44
    # the gaps at 44.5 (inside remat.layer) and 56 (remat.chunk)
    assert _read("idle_in_recompute_ms_per_step", view) == pytest.approx((1 + 2) / 2)
    # plan, readback and the second step's tail; not the gap between steps,
    # nor those inside the backward
    assert _read("idle_in_trainer_ms_per_step", view) == pytest.approx((2 + 5 + 5) / 2)
    four = _view(steps=4)
    assert _read("fcda_chunk_runs_per_step", four) == 22


def test_a_window_without_gaps_reads_zero_idle(recorder):
    view = _view(window=_window([(0, 300)]))
    assert _read("idle_in_recompute_ms_per_step", view) == 0
    assert _read("idle_in_trainer_ms_per_step", view) == 0


def test_nothing_recorded_or_no_recorder_reads_none(recorder, monkeypatch):
    recorder["recs"], recorder["counts"] = [], {}
    assert all(_read(n, _view()) is None for n in NEW)
    # records without device time (the CPU) and without the counter
    recorder["recs"] = [r._replace(device_ms=None) for r in RECORDS]
    assert _read("attention_device_ms_per_step", _view()) is None
    assert _read("fcda_chunk_runs_per_step", _view()) is None
    assert _read("idle_in_trainer_ms_per_step", _view()) is not None
    assert _read("idle_in_trainer_ms_per_step", _view(steps=0)) is None
    # a program without the recorder (the module cannot be imported)
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert all(_read(n, _view()) is None for n in NEW)


def test_the_six_metrics_are_found_by_name(recorder):
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "train_tokens_per_s" and m["workloads"] == CELLS
        assert (run.HERE / "metrics" / f"{name}.py").is_file()
    assert [m["name"] for m in bench["per_layer"] if m["name"] in NEW] == list(NEW)
    cell = run.Cell(bench, CELLS[0], 5, 1.0, True)
    record = {"steps": [{"chunks": 8}] * 2, "batch": 8, "seq": 4096, "tokens": 2 * 8 * 4096,
              "peak_bytes": 1, "modeled_bytes": 1}
    got = run.read_per_layer(bench, cell, run.RunView(cell, record, _window()))
    for name in NEW:
        assert got[name]["unit"] == entries[name]["unit"]
    assert got["fcda_chunk_runs_per_step"]["value"] == 44
