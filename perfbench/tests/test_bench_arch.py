"""Architecture files: Mixtral's held where it was, and a second model
taken from new files alone.

Mixtral's plan, spec and work counts are pinned.  A toy architecture with
a dense layer before its MoE layers, a shared expert and a held share of
the experts (2 of 8, as one chip of an expert-parallel group holds) is
written beside a copy of the harness, as a later configuration would come
in: its spec, weights, work counts, limits and reference are all read from
its own files, and no file of the harness changes."""

import json
import shutil

import pytest
import torch

from perfbench import generator, run, spec, weights, work
from perfbench.arch import mixtral
from perfbench.reference.common import Prec
from perfbench.tests.cpu import digest
from perfbench.trace import Window


def test_mixtrals_plan_is_the_programs_tree_leaf_for_leaf():
    s = mixtral.spec_from_file(spec.load_config_file("mixtral-8x7b-2l"))
    d, V, E, f = 4096, 32000, 8, 14336
    want = [("embed", (V, d), "normal", 0.02), ("final_norm/scale", (d,), "ones32", 0),
            ("head", (d, V), "normal", d ** -0.5)]
    for i in range(2):
        p = f"layers/{i}/"
        want += [(p + "norm1/scale", (d,), "ones32", 0),
                 (p + "mixer/wq", (d, 4096), "normal", d ** -0.5),
                 (p + "mixer/wk", (d, 1024), "normal", d ** -0.5),
                 (p + "mixer/wv", (d, 1024), "normal", d ** -0.5),
                 (p + "mixer/wo", (4096, d), "normal", 4096 ** -0.5),
                 (p + "norm2/scale", (d,), "ones32", 0),
                 (p + "ffn/router/w", (d, E), "normal32", d ** -0.5),
                 (p + "ffn/router/bias", (E,), "zeros32", 0),
                 (p + "ffn/w1", (E, d, f), "normal", d ** -0.5),
                 (p + "ffn/w3", (E, d, f), "normal", d ** -0.5),
                 (p + "ffn/w2", (E, f, d), "normal", f ** -0.5)]
    assert mixtral.plan(s) == want


def test_the_file_and_the_program_give_one_mixtral_spec():
    from repro_torch.configs import get_config
    cfg = spec.load_config_file("mixtral-8x7b-2l")
    port = cfg["port"]
    got = mixtral.spec_from_port(run.port_config(get_config(port["arch"]), port))
    assert got == mixtral.spec_from_file(cfg)
    assert got["experts_held"] == got["n_experts"] == 8
    assert [lay["ffn"] for lay in got["layers"]] == ["moe", "moe"]


TOY_CONFIG = {
    "dim": 32, "vocab_size": 300, "dense_ffn": 48, "expert_ffn": 16, "shared_ffn": 24,
    "experts": 8, "experts_held": 2, "top_k": 2, "dense_layers": 1, "layers": 3,
    "dtype": "float32", "driver": "train", "arch": "toy", "reference": "reference/toy.py",
}

TOY_ARCH = '''
"""A toy: a dense layer, then MoE layers with a shared expert, of whose
experts this chip holds ``experts_held``."""

from perfbench.spec import pad256
from perfbench.work import least_s


def spec_from_file(cfg):
    return {"d_model": cfg["dim"], "vocab": pad256(cfg["vocab_size"]),
            "vocab_size": cfg["vocab_size"], "n_experts": cfg["experts"],
            "experts_held": cfg["experts_held"], "top_k": cfg["top_k"],
            "d_ff": cfg["dense_ffn"], "d_ff_expert": cfg["expert_ffn"],
            "d_ff_shared": cfg["shared_ffn"],
            "layers": [{"mixer": "mlp", "ffn": "dense" if i < cfg["dense_layers"] else "moe"}
                       for i in range(cfg["layers"])]}


def spec_from_port(pcfg):
    return spec_from_file(pcfg)


def plan(spec):
    d, V, H = spec["d_model"], spec["vocab"], spec["experts_held"]
    out = [("embed", (V, d), "normal", 0.02), ("final_norm/scale", (d,), "ones32", 0),
           ("head", (d, V), "normal", d ** -0.5)]
    for i, lay in enumerate(spec["layers"]):
        p = f"layers/{i}/"
        out += [(p + "norm1/scale", (d,), "ones32", 0),
                (p + "mixer/w", (d, d), "normal", d ** -0.5),
                (p + "norm2/scale", (d,), "ones32", 0)]
        if lay["ffn"] == "dense":
            f = spec["d_ff"]
            out += [(p + "ffn/w1", (d, f), "normal", d ** -0.5),
                    (p + "ffn/w3", (d, f), "normal", d ** -0.5),
                    (p + "ffn/w2", (f, d), "normal", f ** -0.5)]
            continue
        f, fs = spec["d_ff_expert"], spec["d_ff_shared"]
        out += [(p + "ffn/router/w", (d, spec["n_experts"]), "normal32", d ** -0.5),
                (p + "ffn/router/bias", (spec["n_experts"],), "zeros32", 0),
                (p + "ffn/w1", (H, d, f), "normal", d ** -0.5),
                (p + "ffn/w3", (H, d, f), "normal", d ** -0.5),
                (p + "ffn/w2", (H, f, d), "normal", f ** -0.5),
                (p + "ffn/shared/w1", (d, fs), "normal", d ** -0.5),
                (p + "ffn/shared/w3", (d, fs), "normal", d ** -0.5),
                (p + "ffn/shared/w2", (fs, d), "normal", fs ** -0.5)]
    return out


def train_flops_per_token(spec, seq):
    d = spec["d_model"]
    per = {"dense": 3 * d * spec["d_ff"],
           "moe": d * spec["n_experts"]
           + 3 * d * (spec["top_k"] * spec["d_ff_expert"] + spec["d_ff_shared"])}
    return 6.0 * (sum(d * d + per[lay["ffn"]] for lay in spec["layers"])
                  + d * spec["vocab"])


def expert_leg_least_s(spec, slots):
    d, f, H = spec["d_model"], spec["d_ff_expert"], spec["experts_held"]
    return least_s(18.0 * slots * d * f, 2 * (2 * 3 * H * d * f + 4 * slots * d))
'''

TOY_REFERENCE = '''
"""The toy's plain fp32 reference: one plain gradient step a batch."""

import torch

from perfbench.reference.common import rmsnorm, swiglu
from perfbench.weights import flat

ADAMW = {"b1": 0.9}


def _ffn(x, f, spec, prec):
    if "router" not in f:
        return swiglu(x, f["w1"], f["w3"], f["w2"], prec)
    gate = torch.softmax(prec.mm(x, f["router"]["w"]), -1)
    y = swiglu(x, f["shared"]["w1"], f["shared"]["w3"], f["shared"]["w2"], prec)
    for e in range(spec["experts_held"]):
        y = y + gate[:, e:e + 1] * swiglu(x, f["w1"][e], f["w3"][e], f["w2"][e], prec)
    return y


def train(params, batches, spec, chunks, lr, prec, rows=None, sample=None):
    leaves = flat(params)
    out = {"loss": [], "grad_norms": None, "from": "toy"}
    for p in leaves:
        p.requires_grad_(True)
    for batch in batches:
        x = params["embed"][batch["tokens"].long().reshape(-1)].float()
        for lp in params["layers"]:
            x = x + prec.mm(rmsnorm(x, lp["norm1"]["scale"], 1e-6), lp["mixer"]["w"])
            x = x + _ffn(rmsnorm(x, lp["norm2"]["scale"], 1e-6), lp["ffn"], spec, prec)
        logits = prec.mm(rmsnorm(x, params["final_norm"]["scale"], 1e-6), params["head"])
        loss = torch.nn.functional.cross_entropy(logits, batch["labels"].long().reshape(-1))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if out["grad_norms"] is None:
            out["grad_norms"] = [0.0 if g is None else float(g.norm()) for g in grads]
            out["grad_sample"] = sample(grads)
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                if g is not None:
                    p.sub_(lr * g)
    for p in leaves:
        p.requires_grad_(False)
    return out
'''

TOY_TRAFFIC = {"kind": "train", "batch": 2, "seq_len": 16, "tokens": {"dist": "uniform"},
               "steps_per_s_cap": 4}
TOY_LIMITS = {"grad_gap": 0.5, "grad_err": 0.5, "delta_gap": 0.5}
CELL = "toy-train-s16-b2"


@pytest.fixture
def toy(tmp_path):
    """A copy of the harness with the toy's five files added, and a
    benchmark that has the toy's cell in both work-count metrics."""
    before = digest(run.HERE)
    root = tmp_path / "perfbench"
    shutil.copytree(run.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    shipped = digest(root)
    (root / "configs" / "toy-moe-3l.json").write_text(json.dumps(TOY_CONFIG))
    (root / "arch" / "toy.py").write_text(TOY_ARCH)
    (root / "reference" / "toy.py").write_text(TOY_REFERENCE)
    (root / "traffic" / "toy-s16-b2.json").write_text(json.dumps(TOY_TRAFFIC))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(TOY_LIMITS))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "toy-moe-3l",
                               "traffic": "toy-s16-b2", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in ("train_mfu_pct", "expert_leg_roofline_pct"):
            m["workloads"] = m["workloads"] + [CELL]
    yield bench, root
    after = digest(root)
    assert {k: v for k, v in after.items() if k in shipped} == shipped
    assert digest(run.HERE) == before


def test_a_second_architecture_comes_in_as_new_files_alone(toy):
    bench, root = toy
    cell = run.Cell(bench, CELL, 7, 1.0, True, root=root)
    assert cell.arch.__file__ == str(root / "arch" / "toy.py")
    assert cell.reference.__file__ == str(root / "reference" / "toy.py")
    assert cell.limits == TOY_LIMITS and cell.mix == TOY_TRAFFIC
    s = cell.spec
    assert (s["n_experts"], s["experts_held"], s["top_k"], s["vocab_size"]) == (8, 2, 2, 300)
    assert [lay["ffn"] for lay in s["layers"]] == ["dense", "moe", "moe"]

    # the weights: the toy's leaves, in its order
    plan = cell.arch.plan(s)
    tree = weights.make(plan, cell.seed, "cpu", torch.float32)
    assert tree["embed"].shape == (512, 32)
    assert tree["layers"][0]["ffn"]["w1"].shape == (32, 48)
    moe = tree["layers"][1]["ffn"]
    assert moe["w1"].shape == (2, 32, 16) and moe["shared"]["w2"].shape == (24, 32)
    leaves = weights.flat(tree)
    assert len(leaves) == len(plan) == 3 + 6 + 2 * 11
    assert all(torch.equal(weights.leaf(plan, cell.seed, i, "cpu", torch.float32), t)
               for i, t in enumerate(leaves))

    # the work counts: the toy's formulas, over the slots of the held experts
    record = {"steps": [{}] * 3, "batch": 2, "seq": 16, "tokens": 3 * 2 * 16}
    w = Window(False)
    w.device, w.window_s = [("FusedUpStore", 0, 2_000_000)], 0.5
    got = run.read_per_layer(bench, cell, run.RunView(cell, record, w))
    d, V = 32, 512
    flops = 6.0 * (3 * d * d + 3 * d * 48 + 2 * (d * 8 + 3 * d * (2 * 16 + 24)) + d * V)
    assert got["train_mfu_pct"]["value"] == pytest.approx(
        100 * 96 * flops / (0.5 * work.BF16_FLOPS))
    slots = 2 * 16 * 2 * 2 / 8
    least = work.least_s(18 * slots * d * 16, 2 * (2 * 3 * 2 * d * 16 + 4 * slots * d))
    assert got["expert_leg_roofline_pct"]["value"] == pytest.approx(
        100 * 3 * 2 * least / 2e-3)

    # the reference: the toy's, on the toy's weights and the mix's rows
    drv = cell.driver()
    cell.device, cell.dtype = "cpu", torch.float32
    cell.feed = generator.train_feed(cell.mix, s["vocab_size"], cell.seed, 0.0, drv.WARM)
    out = drv.reference_readings(cell, [1] * drv.WARM, Prec("fp32"))
    assert out["from"] == "toy" and len(out["loss"]) == drv.WARM
    grad = dict(zip([path for path, *_ in plan], out["grad_norms"]))
    delta = dict(zip([path for path, *_ in plan], out["delta_norms"]))
    for leaf in ("layers/0/ffn/w1", "layers/1/ffn/w1", "layers/2/ffn/shared/w3"):
        assert grad[leaf] > 0 and delta[leaf] > 0, leaf
    assert grad["layers/1/ffn/router/bias"] == 0 == delta["layers/1/ffn/router/bias"]
