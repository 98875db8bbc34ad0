"""Adaptive per-layer MACT in the port against the JAX package: telemetry,
per-layer schedules and their hysteresis, the forward's per-layer vectors,
and the trainer's adaptive loop (the counterparts of
``tests/test_adaptive.py``; its compiled-step LRU test has none: the port
runs eagerly and caches no step).

The same numpy inputs go through both packages: loads, configs and (through
``bridge.params_from_jax``) the JAX init's weights.  Planner outputs
(schedule vectors, MACT's history, the telemetry EMA, chunk traces) must be
equal; logits and losses agree to ``test_torch_train.py``'s 1e-4.  The
reference's controller tests use ``deepseek-mini-8l``, which the port does
not have yet; both packages run them on Mixtral's reduced config.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.core import mact as jmact  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core.chunking import ScheduleSpec as JSpec  # noqa: E402
from repro.core.telemetry import LoadTelemetry as JTelemetry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import mact as tmact  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core.chunking import ScheduleSpec  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.core.telemetry import LoadTelemetry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.training.step import make_train_state  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
torch.set_num_threads(min(torch.get_num_threads(), 2))
HET = ((1, 1), (2, 1), (4, 1), (8, 1))


def _cfg4(base):
    """4 MoE layers, one per period (the reference's ``_cfg4``), built from
    either package's config classes."""
    return base.ModelConfig(
        name="adaptive-t4", family="moe", source="tests",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256,
        pattern=(base.LayerSpec(mixer="attn", ffn="moe", attn=base.AttentionSpec()),),
        moe=base.MoEConfig(num_experts=4, top_k=2, d_ff_expert=96),
        dtype="float32")


def _macts(bins=(1, 2, 4, 8)):
    """Both packages' controllers on Mixtral's reduced config with a small
    HBM and no static bytes, so s'_max is a round, controllable number."""
    jhw = jbase.HardwareProfile("test", hbm_bytes=1e8, peak_flops=1, hbm_bw=1,
                                ici_bw=1, alpha=0.9)
    thw = tbase.HardwareProfile("test", hbm_bytes=1e8, peak_flops=1, hbm_bw=1,
                                ici_bw=1, alpha=0.9)
    jm = jmact.MACTController(registry()["mixtral-8x7b"].reduced(),
                              jmm.Parallelism(e=1, b=1), jhw, seq_len=128, bins=bins,
                              static_override=0.0)
    tm = tmact.MACTController(get_config("mixtral-8x7b").reduced(),
                              tmm.Parallelism(e=1, b=1), thw, seq_len=128, bins=bins,
                              static_override=0.0)
    assert tm.s_prime_max() == jm.s_prime_max() > 0
    return jm, tm


def _loads_for(mact, s_pp: float, layers: int = 1):
    """(layers, E) load matrix whose observed s'' is exactly s_pp (e=1)."""
    return np.full((layers, mact.cfg.moe.num_experts), s_pp / mact.cfg.moe.num_experts)


def _vec(v) -> list:
    return [tuple(s) for s in v]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_telemetry_ema_math_and_shape_guard():
    rng = np.random.default_rng(0)
    t, j = LoadTelemetry(2, 3, decay=0.5), JTelemetry(2, 3, decay=0.5)
    assert t.loads is None and t.imbalance() is None
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    np.testing.assert_array_equal(t.update(a), a)            # first obs initialises
    j.update(a)
    for _ in range(4):
        obs = rng.integers(0, 50, (2, 3))
        np.testing.assert_array_equal(t.update(obs), j.update(obs))
        np.testing.assert_array_equal(t.imbalance(), j.imbalance())
    assert t.steps == j.steps == 5
    assert t.state_dict() == j.state_dict()
    for tel in (t, j):
        with pytest.raises(ValueError):
            tel.update(np.ones((3, 3)))
    t.reset()
    assert t.loads is None and t.steps == 0


# ---------------------------------------------------------------------------
# the forward's per-layer vectors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfg4_params():
    jc, tc = _cfg4(jbase), _cfg4(tbase)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, CPU)
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 32))
    return jc, tc, jp, tp, tokens


def _forward(params, cfg, ctx, tokens):
    with torch.no_grad():
        return transformer.forward(params, cfg, ctx, {"tokens": torch.as_tensor(tokens)})


def test_forward_emits_per_layer_loads_summing_to_global(cfg4_params):
    jc, tc, jp, tp, tokens = cfg4_params
    logits, stats = _forward(tp, tc, DistContext(device=CPU, moe_chunks=2), tokens)
    lpl = stats["load_per_layer"].numpy()
    assert lpl.shape == (4, tc.moe.num_experts)
    np.testing.assert_array_equal(lpl.sum(0), stats["load"].numpy())
    np.testing.assert_array_equal(lpl.sum(1), 2 * 32 * tc.moe.top_k)
    jl, js = jtransformer.forward(jp, jc, jmoe.DistContext(moe_chunks=2),
                                  {"tokens": jax.numpy.asarray(tokens)})
    np.testing.assert_array_equal(lpl, np.asarray(js["load_per_layer"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_uniform_vector_reproduces_static_path_bitwise(cfg4_params):
    _, tc, _, tp, tokens = cfg4_params
    y_static, s_static = _forward(tp, tc, DistContext(device=CPU, moe_chunks=2), tokens)
    uni = tuple(ScheduleSpec(2, 1) for _ in range(4))
    y_vec, s_vec = _forward(tp, tc, DistContext(device=CPU, layer_schedules=uni), tokens)
    assert torch.equal(y_static, y_vec)
    assert torch.equal(s_static["load_per_layer"], s_vec["load_per_layer"])


def test_heterogeneous_vector_matches_loads_and_the_reference(cfg4_params):
    jc, tc, jp, tp, tokens = cfg4_params
    het = tuple(ScheduleSpec(*s) for s in HET)
    y_static, s_static = _forward(tp, tc, DistContext(device=CPU, moe_chunks=1), tokens)
    y_het, s_het = _forward(tp, tc, DistContext(device=CPU, layer_schedules=het), tokens)
    # chunking is numerically (not bitwise) invariant; routing is identical
    assert (y_static - y_het).abs().max() < 1e-4
    assert torch.equal(s_static["load_per_layer"], s_het["load_per_layer"])
    jl, js = jtransformer.forward(
        jp, jc, jmoe.DistContext(layer_schedules=tuple(JSpec(*s) for s in HET)),
        {"tokens": jax.numpy.asarray(tokens)})
    np.testing.assert_array_equal(s_het["load_per_layer"].numpy(),
                                  np.asarray(js["load_per_layer"]))
    np.testing.assert_allclose(y_het.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="MoE layers"):
        _forward(tp, tc, DistContext(device=CPU, layer_schedules=het[:3]), tokens)


# ---------------------------------------------------------------------------
# the controller: per-layer choice and hysteresis, against the reference
# ---------------------------------------------------------------------------

def test_cold_start_plans_worst_case_uniformly():
    jm, tm = _macts()
    vec = tm.choose_layer_schedules(None, 3, max_depth=2)
    assert _vec(vec) == _vec(jm.choose_layer_schedules(None, 3, max_depth=2))
    assert len(set(vec)) == 1 and tuple(vec[0]) == tm.choose_schedule(max_depth=2)


def test_per_layer_choice_tracks_per_layer_load():
    jm, tm = _macts()
    s_max = tm.s_prime_max()
    loads = np.concatenate([_loads_for(tm, 0.5 * s_max), _loads_for(tm, 3.5 * s_max)])
    vec = tm.choose_layer_schedules(loads, 2, max_depth=1)
    assert _vec(vec) == _vec(jm.choose_layer_schedules(loads, 2, max_depth=1))
    assert vec[0].chunks == 1 and vec[1].chunks == 4


@pytest.mark.parametrize("h", (0.0, 0.1))
def test_hysteresis_prevents_flapping_under_noisy_load(h):
    """Load oscillating +-4% around the c=2 -> 3 boundary: without
    hysteresis the bin flips every step, with it one safety up-switch."""
    jm, tm = _macts()
    s_max = tm.s_prime_max()
    cur_t = cur_j = None
    changes = 0
    for eps in (0.04, -0.04, 0.04, -0.04, 0.04, -0.04):
        loads = _loads_for(tm, 2.0 * s_max * (1 + eps))
        vec = tm.choose_layer_schedules(loads, 1, max_depth=1, current=cur_t, hysteresis=h)
        cur_j = jm.choose_layer_schedules(loads, 1, max_depth=1, current=cur_j,
                                          hysteresis=h)
        assert _vec(vec) == _vec(cur_j)
        changes += cur_t is not None and vec != cur_t
        cur_t = vec
    if h:
        assert changes <= 1 and cur_t[0].chunks == 4   # held at the memory-safe bin
    else:
        assert changes >= 3
    assert tm.history == [{"s_pp": r["s_pp"], "layer_schedules": tuple(
        ScheduleSpec(*s) for s in r["layer_schedules"])} for r in jm.history]


def test_safety_switch_overrides_hysteresis():
    jm, tm = _macts()
    loads = _loads_for(tm, 6.0 * tm.s_prime_max())
    kw = dict(max_depth=1, hysteresis=10.0)            # absurd band: safety wins
    vec = tm.choose_layer_schedules(loads, 1, current=(ScheduleSpec(2, 1),), **kw)
    assert _vec(vec) == _vec(jm.choose_layer_schedules(loads, 1, current=(JSpec(2, 1),),
                                                       **kw))
    assert vec[0].chunks == 8


def test_schedule_emissions_within_bucketed_space():
    jm, tm = _macts()
    space = set(tm.schedule_space(max_depth=2))
    assert len(space) == 4 + 3
    rng = np.random.default_rng(0)
    for _ in range(20):
        loads = _loads_for(tm, float(rng.uniform(0.1, 12.0)) * tm.s_prime_max())
        vec = tm.choose_layer_schedules(loads, 1, max_depth=2, headroom=0.2)
        assert set(vec) <= space
        assert _vec(vec) == _vec(jm.choose_layer_schedules(loads, 1, max_depth=2,
                                                           headroom=0.2))


# ---------------------------------------------------------------------------
# the trainer's adaptive loop, against the JAX trainer
# ---------------------------------------------------------------------------

def _trainers(jkw: dict, tkw: dict, jctx=None, tctx=None):
    jc, tc = _cfg4(jbase), _cfg4(tbase)
    kw = dict(seq_len=32, global_batch=2, lr=1e-3)
    jt = jtrainer.Trainer(jc, jctx or jmoe.DistContext(), **kw, **jkw)
    tt = Trainer(tc, tctx or DistContext(device=CPU), **kw, **tkw)
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    return jt, tt, jstate, tstate


def test_user_layer_schedules_honored_without_mact():
    vec = ((1, 1), (2, 1), (4, 1), (2, 1))
    jt, tt, js, ts = _trainers(
        dict(use_mact=False), dict(use_mact=False),
        jmoe.DistContext(layer_schedules=tuple(JSpec(*s) for s in vec)),
        DistContext(device=CPU, layer_schedules=tuple(ScheduleSpec(*s) for s in vec)))
    assert tt._next_schedule_key() == tuple(ScheduleSpec(*s) for s in vec)
    jt.fit(2, js)
    tt.fit(2, ts)
    assert tt.chunk_trace == jt.chunk_trace == [4, 4]   # memory-binding layer
    np.testing.assert_allclose([r["loss"] for r in tt.log], [r["loss"] for r in jt.log],
                               rtol=1e-4, atol=1e-4)


def test_adaptive_fit_records_schedules_as_the_reference():
    kw = dict(use_mact=True, adaptive_mact=True, replan_interval=2, mact_ep_view=4)
    jt, tt, js, ts = _trainers(kw, kw)
    jt.fit(5, js)
    tt.fit(5, ts)
    assert [_vec(v) for v in tt.schedule_trace] == [_vec(v) for v in jt.schedule_trace]
    assert len(tt.schedule_trace) == 5 and all(len(v) == 4 for v in tt.schedule_trace)
    space = set(tt.mact.schedule_space(max_depth=1))
    assert all(set(v) <= space for v in tt.schedule_trace)
    # replan_interval=2 over 5 steps: 3 plans (cold start + 2 re-plans)
    plans = [h for h in tt.mact.history if "layer_schedules" in h]
    assert len(plans) == 3
    assert [h["s_pp"] for h in plans] == [h["s_pp"] for h in jt.mact.history
                                          if "layer_schedules" in h]
    assert tt.telemetry.steps == jt.telemetry.steps == 5
    np.testing.assert_array_equal(tt.telemetry.loads, jt.telemetry.loads)
    assert tt.chunk_trace == jt.chunk_trace
    assert [r["imbalance"] for r in tt.log] == [r["imbalance"] for r in jt.log]
    np.testing.assert_allclose([r["loss"] for r in tt.log], [r["loss"] for r in jt.log],
                               rtol=1e-4, atol=1e-4)


def test_adaptive_uniform_telemetry_matches_static_trainer_losses():
    tc = _cfg4(tbase)
    kw = dict(seq_len=32, global_batch=2, lr=1e-3, mact_ep_view=tc.moe.num_experts)
    tr_s = Trainer(tc, DistContext(device=CPU), use_mact=True, **kw)
    tr_a = Trainer(tc, DistContext(device=CPU), use_mact=True, adaptive_mact=True, **kw)
    tr_s.fit(3)
    tr_a.fit(3)
    # same data, same cold start; the per-layer telemetry is near-uniform, so
    # the adaptive trainer runs the very same schedules: the same losses
    assert [r["loss"] for r in tr_s.log] == [r["loss"] for r in tr_a.log]
    assert tr_s.chunk_trace == tr_a.chunk_trace
