"""DeepSeek-V3 on the port, held against the benchmark's plain fp32
reference (``perfbench/reference/deepseek_v3.py``) at small sizes on the
CPU.  The JAX package has no latent attention, no grouped sigmoid router
and no held share, so the reference here is the plain one.

* MLA's mixer, forward and gradients;
* YaRN's frequencies, temperature and MLA's softmax scale against the
  closed form;
* the grouped sigmoid router, including a case where the group limit
  changes the choice from a plain top-k;
* the held share: the parts that every share [j h, (j + 1) h) of the
  experts gives, the shared expert counted once, add up to the uncut
  reference layer;
* the memory model's held experts, MLA widths and fp32 score term, and
  MACT's s'';
* the spans the layer adds, and the launcher at the reduced size."""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.arch import deepseek_v3 as arch  # noqa: E402
from perfbench.reference import deepseek_v3 as ref  # noqa: E402
from perfbench.reference.common import Prec  # noqa: E402
from repro_torch.configs import H100_80G, get_config  # noqa: E402
from repro_torch.configs.base import AttentionSpec  # noqa: E402
from repro_torch.core import memory_model as mm  # noqa: E402
from repro_torch.core.mact import MACTController  # noqa: E402
from repro_torch.core.moe import DistContext, moe_ffn  # noqa: E402
from repro_torch.core.router import route  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.runtime import spans  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
FP32 = Prec("fp32")
EP = DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True)
torch.set_num_threads(min(torch.get_num_threads(), 2))


def _cfg(**kw):
    """The reduced DeepSeek-V3 cut: 16 experts in 8 groups, top-4 groups,
    top 2, 8 held, unless ``kw`` says otherwise."""
    return get_config("deepseek-v3-ep32").reduced(**{"d_model": 64, "max_experts": 16, **kw})


def _spec(cfg):
    return arch.spec_from_port(cfg)


# ---------------------------------------------------------------------------
# MLA and YaRN
# ---------------------------------------------------------------------------

def test_mla_mixer_forward_and_gradients_match_the_reference():
    cfg = _cfg()
    spec = _spec(cfg)
    p = init_params(cfg, device=CPU, seed=3)["layers"][0]["mixer"]
    torch.manual_seed(0)
    # random norm scales, so that the norms' gradients are not all alike
    for key in ("q_a_norm", "kv_a_norm"):
        p[key]["scale"] = 1 + 0.1 * torch.randn_like(p[key]["scale"])
    leaves = [p["wq_a"], p["q_a_norm"]["scale"], p["wq_b"], p["wkv_a"],
              p["kv_a_norm"]["scale"], p["wkv_b"], p["wo"]]
    for t in leaves:
        t.requires_grad_(True)
    S = 48
    x = torch.randn(2, S, cfg.d_model, requires_grad=True)
    pos = torch.arange(S).expand(2, S)
    got = blocks.mla_mixer(p, x, cfg, cfg.layer_specs()[0], pos)
    dy = torch.randn_like(got)
    g_got = torch.autograd.grad(got, [x, *leaves], dy)
    tables = ref.rope_tables(spec, S, CPU)
    want = torch.stack([FP32.mm(ref.mla(x[b], p, spec, FP32, tables), p["wo"])
                        for b in range(2)])
    g_want = torch.autograd.grad(want, [x, *leaves], dy)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_yarn_frequencies_and_temperature_are_the_closed_form():
    """DeepSeek-V3's numbers: 64 RoPE columns, theta 10000, factor 40 over
    4096 positions, beta 32 / 1.  The correction range is the dimensions
    floor(64 ln(4096 / (32 2 pi)) / (2 ln 10000)) = 10 to
    ceil(64 ln(4096 / (2 pi)) / (2 ln 10000)) = 23."""
    cfg = get_config("deepseek-v3")
    y = cfg.yarn
    lo, hi = 10, 23
    base = [10000.0 ** (-2 * i / 64) for i in range(32)]
    ramp = [min(max((i - lo) / (hi - lo), 0.0), 1.0) for i in range(32)]
    want = torch.tensor([b / 40 * r + b * (1 - r) for b, r in zip(base, ramp)])
    got = layers.yarn_freqs(64, cfg.rope_theta, y)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    spec = arch.spec_from_port(cfg)
    torch.testing.assert_close(ref.yarn_inv_freq(64, 10000.0, spec["yarn"]), want,
                               rtol=1e-6, atol=0)
    assert got[:lo].tolist() == pytest.approx(base[:lo], rel=1e-6)
    assert got[hi:].tolist() == pytest.approx([b / 40 for b in base[hi:]], rel=1e-6)
    m = 0.1 * math.log(40) + 1
    assert layers.yarn_mscale(40.0, 1.0) == pytest.approx(m, rel=1e-12)
    assert blocks.mla_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert ref.softmax_scale(spec) == pytest.approx(blocks.mla_scale(cfg), rel=1e-12)


def test_attention_takes_a_narrower_value_head_and_a_given_scale():
    from repro_torch.configs.base import AttentionSpec
    from repro_torch.models.attention import attention
    torch.manual_seed(1)
    q, k = torch.randn(1, 64, 2, 12), torch.randn(1, 64, 2, 12)
    v = torch.randn(1, 64, 2, 8)
    got = attention(q, k, v, AttentionSpec(), block_q=16, scale=0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_a_latent_attention_config_does_not_serve():
    cfg = _cfg()
    params = init_params(cfg, device=CPU)
    with pytest.raises(NotImplementedError, match="only\\s+trains"):
        blocks.init_layer_cache(cfg.layer_specs()[0], cfg, 1, 8, torch.float32, CPU)
    from repro_torch.models.transformer import forward
    with pytest.raises(NotImplementedError, match="latent cache"):
        forward(params, cfg, EP, {"tokens": torch.zeros(1, 8, dtype=torch.long)},
                return_cache=True)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def _router(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    E = cfg.moe.num_experts
    return {"w": torch.randn(cfg.d_model, E, generator=g) * cfg.d_model ** -0.5,
            "bias": 0.05 * torch.randn(E, generator=g)}


def test_the_grouped_sigmoid_router_matches_the_reference():
    cfg = _cfg()
    spec = _spec(cfg)
    router = _router(cfg)
    x = torch.randn(96, cfg.d_model, generator=torch.Generator().manual_seed(1))
    r = route(router, x, cfg.moe)
    chosen, weights, aff = ref.route(x, router, spec, FP32)
    assert r.expert_idx.long().tolist() == chosen.tolist()
    torch.testing.assert_close(r.weights, weights, rtol=1e-6, atol=1e-7)
    assert torch.all(r.weights.sum(-1).sub(2.5).abs() < 1e-5)
    onehot = (chosen[..., None] == torch.arange(16)).float()
    assert r.load.tolist() == onehot.sum((0, 1)).int().tolist()
    f = onehot.sum(1).mean(0)
    torch.testing.assert_close(r.aux_loss, 16 * (f * aff.mean(0)).sum() / 2)


def test_the_group_limit_changes_the_choice_from_a_plain_top_k():
    """Expert 0 has the highest score, but its group's partner the lowest:
    group 0 ranks below four groups whose two experts both score well, so
    its expert cannot be chosen, where a plain top-2 would choose it."""
    cfg = _cfg()
    E = cfg.moe.num_experts                 # 8 groups of 2, top-4 groups, top 2
    logits = torch.full((E,), -1.0)
    logits[0], logits[1] = 6.0, -6.0        # group 0: 0.9975 + 0.0025
    logits[2:10] = 1.0                      # groups 1-4: 0.73 + 0.73
    logits[10] = 2.0                        # group 5: 0.88 + 0.27, below 1-4
    router = {"w": torch.eye(cfg.d_model, E), "bias": torch.zeros(E)}
    x = torch.zeros(1, cfg.d_model)
    x[0, :E] = logits
    r = route(router, x, cfg.moe)
    plain = route(router, x, dataclasses.replace(cfg.moe, n_group=1))
    assert 0 in plain.expert_idx[0].tolist() and 10 in plain.expert_idx[0].tolist()
    assert r.expert_idx[0].tolist() == [2, 3]
    assert ref.route(x, router, _spec(cfg), FP32)[0][0].tolist() == [2, 3]


def test_the_softmax_router_is_unchanged_by_the_new_fields():
    cfg = get_config("mixtral-8x7b").reduced()
    router = _router(cfg)
    router["bias"].zero_()
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(2))
    r = route(router, x, cfg.moe)
    probs = torch.softmax(x @ router["w"], -1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :2]
    assert r.expert_idx.long().tolist() == idx.tolist()
    gate = torch.gather(probs, -1, idx)
    assert torch.equal(r.weights, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9))


# ---------------------------------------------------------------------------
# the held share
# ---------------------------------------------------------------------------

def _moe_params(cfg, seed=4):
    """One MoE layer's weights with every expert (``held`` = E)."""
    g = torch.Generator().manual_seed(seed)
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    n = lambda *s: torch.randn(*s, generator=g) * s[-2] ** -0.5  # noqa: E731
    return {"router": _router(cfg, seed), "w1": n(E, d, f), "w3": n(E, d, f),
            "w2": n(E, f, d), "shared": {"w1": n(d, f), "w3": n(d, f), "w2": n(f, d)}}


def _share(full: dict, j: int, h: int) -> dict:
    """The weights rank j of an E / h-way group holds, as the program's rank
    0 holds them: its experts [j h, (j + 1) h) first, and the router's
    columns turned by j h, so that they are experts [0, h).  h is a
    multiple of the group size, so the groups turn whole and rank as
    before."""
    roll = lambda t: torch.roll(t, -j * h, dims=-1)  # noqa: E731
    return {"router": {"w": roll(full["router"]["w"]), "bias": roll(full["router"]["bias"])},
            "w1": full["w1"][j * h:(j + 1) * h], "w3": full["w3"][j * h:(j + 1) * h],
            "w2": full["w2"][j * h:(j + 1) * h], "shared": full["shared"]}


@pytest.mark.parametrize("held,chunks", [(8, 1), (4, 2), (2, 4)])
def test_the_shares_add_up_to_the_uncut_reference_layer(held, chunks):
    cfg = _cfg()
    moe = dataclasses.replace(cfg.moe, experts_held=held)
    E = moe.num_experts
    full = _moe_params(cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(5))
    ctx = dataclasses.replace(EP, moe_chunks=chunks)
    spec = {**_spec(cfg), "experts_held": E}
    uncut, _, chosen = ref.moe(x.reshape(-1, cfg.d_model), full, spec, FP32)
    shared = ref.swiglu(x.reshape(-1, cfg.d_model), *full["shared"].values(), FP32)
    total, loads = -(E // held - 1) * shared, []
    for j in range(E // held):
        y, st = moe_ffn(_share(full, j, held), x, moe, ctx)
        total = total + y.reshape(-1, cfg.d_model)
        assert st["drops"].item() == 0
        loads.append(torch.roll(st["load"], j * held))
        assert st["load"].sum().item() == x.shape[0] * x.shape[1] * moe.top_k
    torch.testing.assert_close(total, uncut, rtol=1e-5, atol=1e-5)
    onehot = (chosen[..., None] == torch.arange(E)).float().sum((0, 1))
    for load in loads:                      # every share routes over all E
        assert load.tolist() == onehot.tolist()


def test_a_held_share_runs_only_on_the_ep_strategy_at_one_peer():
    cfg = _cfg()
    params = _share(_moe_params(cfg), 0, cfg.moe.held)
    x = torch.randn(1, 8, cfg.d_model)
    with pytest.raises(ValueError, match="ep_shardmap"):
        moe_ffn(params, x, cfg.moe, DistContext(device=CPU))


# ---------------------------------------------------------------------------
# memory model and MACT
# ---------------------------------------------------------------------------

def test_the_memory_model_counts_the_held_experts_and_mlas_widths():
    cfg = dataclasses.replace(get_config("deepseek-v3-ep32"), num_layers=5)
    par = mm.Parallelism(b=2)
    counts = mm.param_counts(cfg, par)
    h, f = 7168, 2048
    mla = (h * 1536 + 1536 + 1536 * 128 * 192 + h * 576 + 512 + 512 * 128 * 256
           + 128 * 128 * h)
    assert mla == 187_107_328
    assert counts["attn"] == 5 * mla
    assert counts["moe_experts"] == 4 * 8 * 3 * h * f          # 8 held, not 256
    assert counts["moe_shared"] == 4 * 3 * h * f
    assert counts["router"] == 4 * h * 256
    assert counts["dense_ffn"] == 3 * h * 18432
    assert counts["embed"] == counts["lm_head"] == 16160 * h
    assert mm.total_params(cfg) == pytest.approx(3.156e9, rel=1e-3)
    dims = mm.LayerDims.from_config(cfg)
    assert dims.attn_width == 1536 + 512 + 64 + 128 * (2 * 192 + 128)
    assert mm.shared_act_bytes(dims, 4096, par) == 2 * 2 * 4096 * (
        5 * h + dims.attn_width + 256)
    mact = MACTController(cfg, par, H100_80G, 4096, fused=True)
    assert mact.static == mm.static_bytes(cfg, par)
    assert mact.worst_case_s_pp() == 2 * 4096 * 8               # b s min(k, h)
    load = torch.arange(256, dtype=torch.float64).numpy()
    assert mact.observed_s_pp(load) == sum(range(8))           # the held experts'
    # without a held share, MLA's widths and everything else as before
    mix = get_config("mixtral-8x7b")
    d = mm.LayerDims.from_config(mix)
    assert d.attn_width == 0 and mm.shared_act_bytes(d, 64, par) == 2 * 2 * 64 * (
        5 * 4096 + 32 * 128 + 2 * 8 * 128 + 8)
    assert mm.worst_case_s_prime(64, par, 2) == 2 * 64 * 2


def test_the_memory_model_counts_what_mlas_fp32_scores_save(monkeypatch):
    # at a small size: the term is the bytes of the fp32 tensors that
    # ``attention`` saves for its backward, to the byte
    B, S, H, D, V, qb = 2, 64, 4, 12, 8, 16
    gen = torch.Generator().manual_seed(0)
    q, k = (torch.randn(B, S, H, D, generator=gen, dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    v = torch.randn(B, S, H, V, generator=gen, dtype=torch.bfloat16, requires_grad=True)
    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = (t.dtype, t.untyped_storage().nbytes())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        attn_mod.attention(q, k, v, AttentionSpec(kind="full"), block_q=qb)
    fp32 = sum(n for dt, n in saved.values() if dt == torch.float32)
    monkeypatch.setattr(mm, "BLOCK_Q", qb)
    dims = dataclasses.replace(mm.LayerDims.from_config(_cfg()), a=H, score_dim=D)
    assert mm.score_bytes(dims, S, mm.Parallelism(b=B)) == fp32
    monkeypatch.undo()
    # the cell's size: 13.56 GB, once, beside the per-token terms; MACT's
    # plan stays (2, 2), and the model is above the H100's measured peak
    # (69.26 GB) at any load of the held experts
    cfg = dataclasses.replace(get_config("deepseek-v3-ep32"), num_layers=5)
    par = mm.Parallelism(b=2)
    dims = mm.LayerDims.from_config(cfg)
    assert dims.score_dim == 192
    assert mm.score_bytes(dims, 4096, par) == 4 * 2 * 128 * (1024 * 10240
                                                             + 192 * (4096 + 10240))
    act = mm.activation_bytes(dims, 4096, 0, par, copies=2)
    assert act == 2 * mm.shared_act_bytes(dims, 4096, par) + mm.score_bytes(dims, 4096, par)
    mact = MACTController(cfg, par, H100_80G, 4096, fused=True)
    assert mact.choose_schedule(None) == (2, 2)
    assert mact.memory_report(0, 2, 2)["total_gb"] * 2**30 > 69.26e9
    # without MLA there is no such term: the paper's Eq. 2 as before
    assert mm.score_bytes(mm.LayerDims.from_config(get_config("mixtral-8x7b")), 4096,
                          par) == 0


# ---------------------------------------------------------------------------
# spans, counters, the trainer and the launcher
# ---------------------------------------------------------------------------

def test_a_step_records_mla_router_spans_and_the_share_counters():
    cfg = _cfg()
    B, S, chunks = 2, 32, 2
    ctx = dataclasses.replace(EP, moe_chunks=chunks, pipeline_chunks=1)
    tr = Trainer(cfg, ctx, seq_len=S, global_batch=B, use_mact=False)
    state = tr.fit(1)
    spans.clear()
    spans.enable()
    try:
        tr.fit(1, state)
    finally:
        spans.enable(None)
    by = {}
    for r in spans.records():
        by.setdefault(r.name, []).append(r)
    n_layers, n_moe = cfg.num_layers, 1
    # the layer recompute runs each mixer again: twice forward, once backward
    assert len(by["mla.proj"]) == len(by["attn"]) == 2 * n_layers
    assert len(by["mla.proj.bwd"]) == len(by["attn.bwd"]) == n_layers
    for inner, outer in (("mla.proj", "attn"), ("mla.proj.bwd", "attn.bwd")):
        for a in by[inner]:
            assert any(o.start_ns <= a.start_ns <= a.end_ns <= o.end_ns for o in by[outer])
    # the router: c chunks forward, c in the chunk recompute, and c in the
    # layer's recompute, which runs on past the last chunk to the shared
    # expert after it
    assert len(by["moe.route"]) == n_moe * 3 * chunks
    assert tr.log[-1]["drops"] == 0
    spans.clear()


def test_the_launcher_trains_deepseek_at_the_reduced_size(capsys):
    trainer, state = tlaunch.main(["--arch", "deepseek-v3-ep32", "--smoke", "--device",
                                   "cpu", "--ep", "--fused", "--steps", "2",
                                   "--seq-len", "32", "--global-batch", "2"])
    out = capsys.readouterr().out
    assert "deepseek-v3-ep32-smoke" in out and "EP at one peer" in out
    assert len(trainer.log) == 2 and all(math.isfinite(r["loss"]) for r in trainer.log)
    assert trainer.log[-1]["drops"] == 0
    w1 = state.params["layers"][1]["ffn"]["w1"]
    assert w1.shape[0] == trainer.cfg.moe.held < trainer.cfg.moe.num_experts
