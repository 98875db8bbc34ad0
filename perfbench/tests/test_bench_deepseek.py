"""DeepSeek-V3's files in the harness: its configuration file, its
architecture file against the program's tree, its work counts, the three
readers the cell adds, and the program against the plain reference
(``reference/deepseek_v3.py``) over three steps of ``Trainer.fit``.

The CPU cell is built here and not by ``tests/cpu.py::cpu_cell``: its
reduction (4 experts, 2 held) leaves the grouped router one expert group
to choose from, where this one holds 8 of 16 experts in 8 groups."""

import dataclasses
import json
import math

import pytest
import torch

from perfbench import check, generator, run, spec, weights, work
from perfbench.arch import deepseek_v3 as arch
from perfbench.reference.common import Prec
from perfbench.tests.cpu import SMALL_TRAIN
from perfbench.trace import Window

CELL = "deepseek-v3-train-s4k-b2-uniform"
CONFIG = "deepseek-v3-ep32-5l"


def _bench() -> dict:
    return json.loads((run.ROOT / "BENCHMARK.json").read_text())


def small_cell(seed: int = 1234567891, **reduce) -> run.Cell:
    """The cell on the CPU at a reduced DeepSeek-V3: 16 experts in 8
    groups, top-4 groups, top 2, 8 held, fp32, the mix cut to a test."""
    from repro_torch.configs import get_config
    torch.set_num_threads(4)
    cell = run.Cell(_bench(), CELL, seed, 2.0, False)
    port = cell.config["port"]
    pc = get_config(port["arch"]).reduced(**{"d_model": 64, "max_experts": 16, **reduce})
    cell.pcfg, cell.spec = pc, cell.arch.spec_from_port(pc)
    cell.device, cell.dtype = "cpu", torch.float32
    cell.mix = {**cell.mix, **SMALL_TRAIN}
    return cell


def test_the_file_states_every_cut_and_the_program_is_the_file():
    from repro_torch.configs import get_config
    cfg = spec.load_config_file(CONFIG)
    cut = {"num_hidden_layers": (5, 61), "first_k_dense_replace": (1, 3),
           "n_routed_experts": (8, 256), "vocab_size": (16160, 129280),
           "num_nextn_predict_layers": (0, 1)}
    assert sorted(cfg["reduced"]) == sorted(cut)
    for key, (run_as, published) in cut.items():
        assert (cfg[key], cfg["published"][key]) == (run_as, published), key
        assert cfg["why_changed"][key], key
    assert {"aux_loss_alpha", "bias_update_speed", "rope_columns", "weights",
            "optimizer"} <= set(cfg["assumed"])
    assert "32-way" in cfg["deployment"]
    entry = {c["name"]: c for c in _bench()["configs"]}[CONFIG]
    assert entry["reduced"] == cfg["reduced"] and entry["file"].endswith(CONFIG + ".json")
    s = arch.spec_from_file(cfg)
    # the router keeps its published width, top 8, groups and scaling
    assert (s["n_experts"], s["experts_held"], s["top_k"]) == (256, 8, 8)
    assert (s["n_group"], s["topk_group"], s["routed_scaling"]) == (8, 4, 2.5)
    assert [lay["ffn"] for lay in s["layers"]] == ["dense"] + ["moe"] * 4
    port = cfg["port"]
    assert arch.spec_from_port(run.port_config(get_config(port["arch"]), port)) == s


def test_the_plan_is_the_programs_tree_leaf_for_leaf():
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import named_params
    cell = small_cell()
    plan = cell.arch.plan(cell.spec)
    got = [(path.strip("/"), tuple(t.shape), t.dtype)
           for path, t in named_params(init_params(cell.pcfg, device="cpu"))]
    want = [(path, shape, torch.float32) for path, shape, *_ in plan]
    assert got == want
    moe = [path for path, shape, *_ in plan if path.startswith("layers/1/ffn/")]
    assert moe == [f"layers/1/ffn/{n}" for n in ("router/w", "router/bias", "w1", "w3", "w2",
                                                  "shared/w1", "shared/w3", "shared/w2")]


def test_the_work_counts_are_the_cells_and_count_the_held_experts():
    s = arch.spec_from_file(spec.load_config_file(CONFIG))
    d, H, f = 7168, 128, 2048
    mla = d * 1536 + 1536 * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    moe = d * 256 + 3 * d * f + 8 * 8 / 256 * 3 * d * f
    active = 5 * mla + 3 * d * 18432 + 4 * moe + d * 16384
    assert arch.active_matmul_params(s) == pytest.approx(active, rel=1e-12)
    attn = 2 * H * (192 + 128) * 4096 * 4097 / 2 * 5 / 4096
    assert arch.train_flops_per_token(s, 4096) == pytest.approx(6 * active + 3 * attn,
                                                                rel=1e-12)
    slots = 2 * 4096 * 8 * 8 / 256
    assert arch.expert_leg_least_s(s, slots) == work.least_s(
        18 * slots * d * f, 2 * (2 * 3 * 8 * d * f + 4 * slots * d))
    leaves = arch.plan(s)
    assert sum(math.prod(shape) for _, shape, *_ in leaves) == pytest.approx(3.16e9, rel=2e-3)


def _read(name, view):
    return run.load_module(run.HERE / "metrics" / f"{name}.py", "t_" + name).read(view)


def test_the_new_readers_read_the_spans_and_counters(monkeypatch):
    from types import SimpleNamespace

    from repro_torch.runtime import spans
    ms = 1_000_000
    recs = [spans.Record("attn", 0, None, 1, 0, 10 * ms, 9.0),
            spans.Record("mla.proj", 1, 0, 1, 1 * ms, 3 * ms, 1.5),
            spans.Record("mla.proj.bwd", 2, None, 2, 20 * ms, 25 * ms, 2.5),
            spans.Record("moe.route", 3, None, 1, 30 * ms, 31 * ms, 0.25),
            spans.Record("moe.route", 4, None, 1, 32 * ms, 33 * ms, 0.75)]
    held = {"recs": recs, "counts": {"fcda.chunk_runs": 4}}
    monkeypatch.setattr(spans, "records", lambda: list(held["recs"]))
    monkeypatch.setattr(spans, "counters", lambda: dict(held["counts"]))
    view = lambda: SimpleNamespace(record={"steps": [{}] * 2}, window=Window(False))  # noqa: E731
    assert _read("mla_proj_device_ms_per_step", view()) == pytest.approx((1.5 + 2.5) / 2)
    assert _read("router_device_ms_per_step", view()) == pytest.approx((0.25 + 0.75) / 2)
    # a program without the spans: the readers find nothing
    held["recs"] = [r for r in recs if r.name == "attn"]
    assert all(_read(n, view()) is None for n in ("mla_proj_device_ms_per_step",
                                                  "router_device_ms_per_step"))


def test_the_cell_reports_the_metrics_it_is_listed_in():
    bench = _bench()
    per = {m["name"]: m for m in bench["per_layer"]}
    assert per["mla_proj_device_ms_per_step"]["workloads"] == [CELL]
    mixtral = ["mixtral-train-s4k-b8-uniform", "mixtral-train-s4k-b2-uniform"]
    assert per["router_device_ms_per_step"]["workloads"] == mixtral + [CELL]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in ("train_tokens_per_s", "train_peak_gb"):
        assert CELL in e2e[name]["workloads"]
    cell = run.Cell(bench, CELL, 11, 1.0, True)
    assert cell.mix == {"kind": "train", "batch": 2, "seq_len": 4096,
                        "tokens": {"dist": "uniform"}, "steps_per_s_cap": 4}
    assert set(cell.limits) == {"grad_gap", "grad_err", "delta_gap"}


def test_the_program_follows_the_reference_step_for_step():
    """Three steps of ``Trainer.fit`` (the EP strategy at one peer holding 8
    of 16 experts, the fused leg, MACT) against the reference's, both in
    fp32, to the gaps ``test_bench_reference.py`` holds Mixtral to: the
    MLA, the grouped router, the held share, the balance loss and the
    bias step are the same mathematics."""
    cell = small_cell()
    drv = cell.driver()
    cell.feed = generator.train_feed(cell.mix, cell.spec["vocab_size"], cell.seed,
                                     0.0, drv.WARM)
    trainer, state = drv.build(cell)
    state, prog = drv.warm(trainer, state, cell)
    assert all(r["drops"] == 0 for r in trainer.log)
    ref = drv.reference_readings(cell, prog["chunks"], Prec("fp32"))
    gaps = check.train_gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["delta_gap"] < 1e-4, gaps
    # the router biases moved by the loss-free step in the program and the
    # reference alike: at most the rate a step, three steps
    bias = state.params["layers"][1]["ffn"]["router"]["bias"]
    assert 0 < float(bias.detach().abs().max()) <= 3 * cell.spec["bias_rate"] + 1e-6


def test_a_chunk_across_sequences_counts_its_routing_over_both():
    """One chunk over 4 rows: the reference's counting pre-pass, held
    against the program."""
    cell = small_cell()
    cell.mix = {**cell.mix, "batch": 4, "seq_len": 32}
    drv = cell.driver()
    cell.feed = generator.train_feed(cell.mix, cell.spec["vocab_size"], cell.seed,
                                     0.0, drv.WARM)
    trainer, state = drv.build(cell)
    trainer.use_mact = False
    trainer.ctx = dataclasses.replace(trainer.ctx, moe_chunks=1, pipeline_chunks=1)
    state, prog = drv.warm(trainer, state, cell)
    assert prog["chunks"] == [1, 1, 1]
    ref = drv.reference_readings(cell, prog["chunks"], Prec("fp32"))
    gaps = check.train_gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4, gaps


def test_the_weights_are_the_plans():
    cell = small_cell(seed=2**31 + 77)
    plan = cell.arch.plan(cell.spec)
    tree = weights.make(plan, cell.seed, "cpu", torch.float32)
    assert tree["layers"][1]["ffn"]["w1"].shape == (8, 64, 128)
    assert tree["layers"][1]["ffn"]["router"]["w"].shape == (64, 16)
    assert tree["layers"][0]["mixer"]["wkv_b"].shape == (16, 4 * (8 + 8))
