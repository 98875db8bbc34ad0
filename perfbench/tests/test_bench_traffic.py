"""The traffic generator, and a cell, a mix and a metric found by name."""

import json
import shutil

import numpy as np

from perfbench import generator, run
from perfbench.arch.mixtral import spec_from_file
from perfbench.spec import load_config_file
from perfbench.tests.cpu import digest

ZIPF = generator.load_traffic_file("mixtral-s4k-b8-zipf")


def test_training_batches_are_seeded_zipf_rows_with_next_token_labels():
    fa = generator.train_feed(ZIPF, 32000, 99, 1.0, 3)
    a, b = fa.made, generator.train_feed(ZIPF, 32000, 99, 1.0, 3).made
    c = generator.train_feed(ZIPF, 32000, 98, 1.0, 3).made
    assert len(a) == 3 + 2 + 1
    # a step past those made ahead is drawn the same way
    late = generator.TrainFeed(ZIPF, 32000, 99).batch(5)
    assert (late["tokens"] == a[5]["tokens"]).all()
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    assert not (a[0]["tokens"] == c[0]["tokens"]).all()
    t = a[0]["tokens"]
    assert t.shape == (8, 4096) and t.dtype == np.int32
    assert (a[0]["labels"][:, :-1] == t[:, 1:]).all()
    counts = np.bincount(t.ravel(), minlength=32000)
    # Zipf(1) over 32000 ranks: the top id takes 1 / H(32000) ~ 9.2% of tokens
    assert 0.08 < counts.max() / t.size < 0.105
    assert len({tuple(r) for r in t}) == 8                    # rows all differ


def test_a_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    before = digest(run.HERE)
    root = tmp_path / "perfbench"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    shipped = digest(root)
    cfg = load_config_file("mixtral-8x7b-2l")
    (root / "configs" / "mixtral-8x7b-4l.json").write_text(
        json.dumps({**cfg, "num_hidden_layers": 4, "port": {**cfg["port"], "num_layers": 4}}))
    (root / "traffic" / "s2k-b4-zipf12.json").write_text(json.dumps(
        {**ZIPF, "batch": 4, "seq_len": 2048, "tokens": {"dist": "zipf", "exponent": 1.2}}))
    (root / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return len(run.record['steps'])\n")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new-cell", "config": "mixtral-8x7b-4l",
                               "traffic": "s2k-b4-zipf12", "chips": 1, "why": "test"})
    # a quantity split by the end-to-end metric it moves: its reader is
    # found by the name before the first dot
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "trainer and MACT",
                               "moves": "train_tokens_per_s", "workloads": ["new-cell"]})
    cell = run.Cell(bench, "new-cell", 5, 1.0, True, root=root)
    assert cell.spec == {**spec_from_file(cfg), "layers": [{"mixer": "attn", "ffn": "moe"}] * 4}
    assert cell.mix["tokens"]["exponent"] == 1.2
    assert cell.driver().__name__ == "perfbench_driver_train"
    got = run.read_per_layer(bench, cell, run.RunView(cell, {"steps": [1, 2, 3]}, None))
    assert got == {"steps_in_window.train": {"value": 3.0, "unit": "steps"}}
    after = digest(root)
    assert {k: v for k, v in after.items() if k in shipped} == shipped
    assert digest(run.HERE) == before
