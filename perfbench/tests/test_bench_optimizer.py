"""The reader of ``optimizer_fused_share`` on synthetic counters: the
kernel's elements over every element AdamW updated in the window; a program
without the counters (or no recorder) reads None, and the metric is found
by name from ``BENCHMARK.json`` in both training cells."""

import json
import sys
from types import SimpleNamespace

import pytest

from perfbench import run
from perfbench.trace import Window
from repro_torch.runtime import spans

NAME = "optimizer_fused_share"
CELLS = ["mixtral-train-s4k-b8-uniform", "mixtral-train-s4k-b2-uniform"]


@pytest.fixture
def counters(monkeypatch):
    held = {}
    monkeypatch.setattr(spans, "records", lambda: [])
    monkeypatch.setattr(spans, "counters", lambda: dict(held))
    return held


def _read(view=None):
    view = view or SimpleNamespace(record={"steps": [{}] * 3}, window=Window(False))
    return run.load_module(run.HERE / "metrics" / f"{NAME}.py", "t_" + NAME).read(view)


@pytest.mark.parametrize("counts,want", [
    ({"adamw.elems": 300, "adamw.fused_elems": 300}, 1.0),
    ({"adamw.elems": 400, "adamw.fused_elems": 100}, 0.25),
    ({"adamw.elems": 300}, 0.0),                          # the plain path only
    ({"adamw.elems": 0, "adamw.fused_elems": 0}, None),
    ({"fcda.chunk_runs": 8}, None),                       # a program without the counters
    ({}, None),
])
def test_the_share_is_the_kernels_elements_over_every_element(counters, counts, want):
    counters.update(counts)
    assert _read() == want


def test_no_recorder_reads_none(counters, monkeypatch):
    counters.update({"adamw.elems": 3, "adamw.fused_elems": 3})
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    assert _read() is None


def test_the_metric_is_found_by_name_in_both_training_cells(counters):
    counters.update({"adamw.elems": 10, "adamw.fused_elems": 10})
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert entry["layer"] == "optimizer" and entry["source"] == "program_counter"
    assert entry["moves"] == "train_tokens_per_s" and entry["workloads"] == CELLS
    for cell_name in CELLS:
        cell = run.Cell(bench, cell_name, 5, 1.0, True)
        record = {"steps": [{"chunks": 2}] * 2, "batch": 2, "seq": 4096,
                  "tokens": 2 * 2 * 4096, "peak_bytes": 1, "modeled_bytes": 1}
        w = Window(False)
        w.device, w.window_s = [], 0.1
        got = run.read_per_layer(bench, cell, run.RunView(cell, record, w))
        assert got[NAME] == {"value": 1.0, "unit": "ratio"}
