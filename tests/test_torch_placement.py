"""Expert placement in the port against the JAX package: the telemetry's
restore guard and imbalance, ``PlacementSpec`` and its tables, the solver
(LPT, replication, hysteresis, migration counts), MACT's pricing through a
placement, and the trainer's replan cadence and checkpoint round trip (the
counterparts of ``tests/test_placement.py``'s single-process tests).

The same loads go through both packages and every planner output must be
equal: placements, ``migrated_slots``, ``observed_s_pp``, per-layer
schedule vectors, the slot tables and ``place_expert_idx``'s slot ids.
The reference's trainer tests use ``deepseek-mini-8l``, which the port does
not have yet; both packages run them on Mixtral's reduced config.  The
layer and the trainer across ranks are ``test_torch_placement_ep.py``'s.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.core import mact as jmact  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.core import placement as jplc  # noqa: E402
from repro.core.telemetry import LoadTelemetry as JTelemetry  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import mact as tmact  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core import placement as plc  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.core.placement import PlacementSpec  # noqa: E402
from repro_torch.core.telemetry import LoadTelemetry  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
HOT = [100, 1, 1, 1, 1, 1, 1, 1]          # one dominant expert, E=8
# (load, peers, replicas): skewed, hot-pair, flat and random loads
CASES = [(HOT, 4, 1), ([100, 50, 1, 1, 1, 1, 1, 1], 4, 0),
         ([100, 50, 1, 1, 1, 1, 1, 1], 4, 1), ([100, 50, 1, 1, 1, 1, 1, 1], 2, 2),
         ([10, 9.8, 10, 9.9, 10, 9.7, 10, 9.9], 4, 1), ([0] * 8, 2, 1),
         *[(list(np.random.default_rng(s).gamma(0.5, 100, 8)), p, r)
           for s, (p, r) in enumerate([(2, 0), (2, 1), (4, 1), (4, 2), (8, 0)])]]


def _same(spec: PlacementSpec, ref) -> bool:
    return (spec.num_experts, spec.num_peers, spec.slot_to_expert) == tuple(ref)


def _jspec(spec: PlacementSpec):
    return jplc.PlacementSpec(spec.num_experts, spec.num_peers, spec.slot_to_expert)


# ---------------------------------------------------------------------------
# telemetry: restore guard and imbalance
# ---------------------------------------------------------------------------

def test_bad_restore_leaves_live_ema_untouched():
    t = LoadTelemetry(num_layers=2, num_experts=3)
    warm = np.arange(6, dtype=np.float64).reshape(2, 3)
    t.update(warm)
    with pytest.raises(ValueError):
        t.load_state_dict({"steps": 99, "ema": np.ones((4, 4)).tolist()})
    assert t.steps == 1 and np.array_equal(t.loads, warm)
    t.load_state_dict({"steps": 7, "ema": (warm * 2).tolist()})
    assert t.steps == 7 and np.array_equal(t.loads, warm * 2)
    j = JTelemetry(num_layers=2, num_experts=3)
    j.load_state_dict(t.state_dict())            # the checkpoint's dict crosses
    assert j.state_dict() == t.state_dict()


def test_imbalance_peak_over_mean():
    t, j = LoadTelemetry(3, 4), JTelemetry(3, 4)
    assert t.imbalance() is None
    obs = [[1, 1, 1, 1], [8, 0, 0, 0], [0, 0, 0, 0]]
    t.update(obs)
    j.update(obs)
    np.testing.assert_array_equal(t.imbalance(), j.imbalance())
    assert np.allclose(t.imbalance(), [1.0, 4.0, 1.0])   # an all-zero layer: 1.0


# ---------------------------------------------------------------------------
# PlacementSpec
# ---------------------------------------------------------------------------

def test_identity_spec_properties():
    s = PlacementSpec.identity(8, 4)
    assert s.total_slots == 8 and s.slots_per_peer == 2
    assert s.replica_slots == 0 and s.is_identity
    s.validate()
    assert np.array_equal(s.replica_counts(), np.ones(8))
    assert _same(s, jplc.PlacementSpec.identity(8, 4))
    with pytest.raises(ValueError):
        PlacementSpec.identity(6, 4)


@pytest.mark.parametrize("args", [(4, 2, (0, 1, 2, 3, 0)), (4, 2, (0, 0, 2, 3)),
                                  (4, 2, (0, 1, 2, 0)), (8, 2, (0, 1))])
def test_validate_rejects_malformed_specs(args):
    with pytest.raises(ValueError):
        jplc.PlacementSpec(*args).validate()
    with pytest.raises(ValueError):
        PlacementSpec(*args).validate()


def test_peer_loads_identity_matches_reshape_sum():
    s = PlacementSpec.identity(8, 4)
    load = np.arange(8, dtype=np.float64) + 1
    assert np.array_equal(s.peer_loads(load), load.reshape(4, 2).sum(1))
    with pytest.raises(ValueError):
        s.peer_loads(np.ones(5))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_slot_tables_and_peer_loads_equal_the_reference(case):
    load, peers, replicas = CASES[case]
    s = plc.plan_placement(load, peers, replicas=replicas)
    js = _jspec(s)
    np.testing.assert_array_equal(s.replica_counts(), js.replica_counts())
    np.testing.assert_array_equal(s.expert_slot_table(), js.expert_slot_table())
    np.testing.assert_array_equal(s.peer_loads(load), js.peer_loads(load))
    assert plc.bottleneck(s, load) == jplc.bottleneck(js, load)
    table = s.expert_slot_table()
    for e in range(s.num_experts):
        slots, counts = np.unique(table[e], return_counts=True)
        assert np.all(np.asarray(s.slot_to_expert)[slots] == e)
        assert counts.max() - counts.min() == 0          # exact round robin


@pytest.mark.parametrize("case", range(len(CASES)))
def test_place_expert_idx_equals_the_reference(case):
    load, peers, replicas = CASES[case]
    s = plc.plan_placement(load, peers, replicas=replicas)
    E = s.num_experts
    rng = np.random.default_rng(case)
    idx = np.stack([rng.permutation(E)[:2] for _ in range(24)]).astype(np.int32)
    got = plc.place_expert_idx(torch.from_numpy(idx), s)
    want = np.asarray(jplc.place_expert_idx(jnp.asarray(idx), _jspec(s)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_place_expert_idx_identity_and_even_split():
    ident = PlacementSpec.identity(4, 2)
    idx = torch.zeros((16, 2), dtype=torch.int32)
    assert plc.place_expert_idx(idx, None) is idx
    assert plc.place_expert_idx(idx, ident) is idx
    s = plc.plan_placement(HOT, 4, replicas=1)
    slots = plc.place_expert_idx(idx, s)                   # all route expert 0
    hosts = [i for i, e in enumerate(s.slot_to_expert) if e == 0]
    counts = np.bincount(slots.reshape(-1).numpy(), minlength=s.total_slots)
    assert sorted(np.nonzero(counts)[0]) == sorted(hosts)
    assert counts[hosts].max() - counts[hosts].min() <= 1
    assert torch.equal(slots, plc.place_expert_idx(idx, s))


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(CASES)))
def test_plan_placement_equals_the_reference(case):
    load, peers, replicas = CASES[case]
    s = plc.plan_placement(load, peers, replicas=replicas)
    s.validate()
    assert _same(s, jplc.plan_placement(load, peers, replicas=replicas))
    assert s.total_slots == s.num_experts + peers * replicas


def test_lpt_beats_identity_when_hot_experts_collide():
    load = [100, 50, 1, 1, 1, 1, 1, 1]
    s = plc.plan_placement(load, 4)
    assert s.total_slots == 8                               # pure permutation
    assert plc.bottleneck(s, load) < plc.bottleneck(PlacementSpec.identity(8, 4), load)
    assert plc.bottleneck(s, load) <= 101 + 1e-9            # LPT optimum here


def test_replication_cuts_below_single_expert_floor():
    perm = plc.plan_placement(HOT, 4)
    rep = plc.plan_placement(HOT, 4, replicas=1)
    assert rep.total_slots == 12 and rep.replica_counts()[0] >= 2
    assert plc.bottleneck(perm, HOT) >= 100 > plc.bottleneck(rep, HOT)
    for mod in (plc, jplc):
        with pytest.raises(ValueError):
            mod.plan_placement(HOT, 4, replicas=-1)
        with pytest.raises(ValueError):
            mod.plan_placement(HOT, 3)                      # E % P != 0


def test_hysteresis_band_and_fixed_point_equal_the_reference():
    ident, jident = PlacementSpec.identity(8, 4), jplc.PlacementSpec.identity(8, 4)
    assert all(p.is_identity for p in plc.choose_placements(np.ones((3, 8)), 3, 4))
    skew = np.asarray([[100, 50, 1, 1, 1, 1, 1, 1]])
    adopted = plc.choose_placements(skew, 1, 4, current=(ident,))
    assert not adopted[0].is_identity
    assert _same(adopted[0], jplc.choose_placements(skew, 1, 4, current=(jident,))[0])
    mild = np.asarray([[10, 9.8, 10, 9.9, 10, 9.7, 10, 9.9]])
    assert plc.choose_placements(mild, 1, 4, current=(ident,))[0] == ident
    assert plc.choose_placements(skew, 1, 4, current=adopted) == adopted


@pytest.mark.parametrize("hysteresis", (0.0, 0.1, 0.5))
@pytest.mark.parametrize("replicas", (0, 1))
def test_choose_placements_over_a_load_stream_equals_the_reference(hysteresis, replicas):
    rng = np.random.default_rng(7)
    cur = jcur = None
    tel, jtel = LoadTelemetry(3, 8), JTelemetry(3, 8)
    for _ in range(6):
        obs = rng.gamma(0.7, 50, (3, 8)) * np.array([[4], [1], [2]])
        tel.update(obs)
        jtel.update(obs)
        new = plc.choose_placements(tel.loads, 3, 4, replicas=replicas, current=cur,
                                    hysteresis=hysteresis)
        jnew = jplc.choose_placements(jtel.loads, 3, 4, replicas=replicas, current=jcur,
                                      hysteresis=hysteresis)
        assert all(_same(a, b) for a, b in zip(new, jnew))
        for j in range(3):
            old = cur[j] if cur is not None else None
            jold = jcur[j] if jcur is not None else None
            assert plc.migrated_slots(old, new[j]) == jplc.migrated_slots(jold, jnew[j])
        cur, jcur = new, jnew


def test_choose_placements_cold_start_and_shape_guard():
    out = plc.choose_placements(None, 2, 4, num_experts=8)
    assert all(p.is_identity for p in out) and len(out) == 2
    cur = (plc.plan_placement([100, 50, 1, 1, 1, 1, 1, 1], 4),) * 2
    assert plc.choose_placements(None, 2, 4, num_experts=8, current=cur) == cur
    with pytest.raises(ValueError):
        plc.choose_placements(np.ones((3, 8)), 2, 4)
    with pytest.raises(ValueError):
        plc.choose_placements(None, 2, 4)                   # num_experts required


def test_migrated_slots_accounting():
    ident = PlacementSpec.identity(8, 4)
    assert plc.migrated_slots(None, ident) == plc.migrated_slots(ident, ident) == 0
    perm = PlacementSpec(8, 4, (1, 0, 2, 3, 4, 5, 6, 7))
    assert plc.migrated_slots(ident, perm) == 2
    rep = plc.plan_placement(HOT, 4, replicas=1)
    assert plc.migrated_slots(rep, rep) == 0
    assert plc.migrated_slots(None, rep) == jplc.migrated_slots(None, _jspec(rep))
    assert plc.migrated_slots(None, rep) >= rep.num_peers * rep.replica_slots
    assert plc.migrated_slots(PlacementSpec.identity(8, 2), rep) == rep.total_slots


# ---------------------------------------------------------------------------
# MACT and the memory model through a placement
# ---------------------------------------------------------------------------

def _macts(**kw):
    jhw = jbase.HardwareProfile("test", hbm_bytes=1e8, peak_flops=1, hbm_bw=1,
                                ici_bw=1, alpha=0.9)
    thw = tbase.HardwareProfile("test", hbm_bytes=1e8, peak_flops=1, hbm_bw=1,
                                ici_bw=1, alpha=0.9)
    return (jmact.MACTController(registry()["mixtral-8x7b"].reduced(),
                                 jmm.Parallelism(e=1, b=1), jhw, seq_len=128,
                                 static_override=0.0, **kw),
            tmact.MACTController(get_config("mixtral-8x7b").reduced(),
                                 tmm.Parallelism(e=1, b=1), thw, seq_len=128,
                                 static_override=0.0, **kw))


def test_observed_s_pp_through_placement_map():
    jm, tm = _macts()
    load = np.asarray([10.0, 10.0, 0.1, 0.1])
    ident = PlacementSpec.identity(4, 2)
    assert tm.observed_s_pp(load, ep_size=2) == tm.observed_s_pp(
        load, placement=ident) == 20.0
    balanced = plc.plan_placement(load, 2)
    assert tm.observed_s_pp(load, placement=balanced) == pytest.approx(10.1)
    for case in range(len(CASES)):
        l8, peers, replicas = CASES[case]
        s = plc.plan_placement(l8, peers, replicas=replicas)
        assert tm.observed_s_pp(l8, placement=s) == jm.observed_s_pp(
            l8, placement=_jspec(s))


def test_replica_weight_bytes_monotone_and_prices_budget():
    cfg = get_config("mixtral-8x7b").reduced()
    par = tmm.Parallelism(e=2, b=1)
    assert tmm.replica_weight_bytes(cfg, 0, par) == 0.0
    b1, b2 = tmm.replica_weight_bytes(cfg, 1, par), tmm.replica_weight_bytes(cfg, 2, par)
    assert 0 < b1 < b2 and b2 == pytest.approx(2 * b1)
    assert b1 == jmm.replica_weight_bytes(registry()["mixtral-8x7b"].reduced(), 1,
                                          jmm.Parallelism(e=2, b=1))
    (j0, m0), (j1, m1) = _macts(), _macts(replica_slots=1)
    assert m1.s_prime_max() < m0.s_prime_max()
    assert (m0.s_prime_max(), m1.s_prime_max()) == (j0.s_prime_max(), j1.s_prime_max())


def test_placed_layer_gets_cheaper_or_equal_schedule():
    jm, tm = _macts()
    E = tm.cfg.moe.num_experts
    load = np.zeros((1, E))
    load[0, :2] = tm.s_prime_max() * 0.9          # a hot pair on one peer
    balanced = plc.plan_placement(load[0], 2)
    plain = tm.choose_layer_schedules(load, 1, ep_size=2)
    placed = tm.choose_layer_schedules(load, 1, ep_size=2, placements=(balanced,))
    assert placed[0].chunks <= plain[0].chunks
    assert [tuple(s) for s in placed] == [tuple(s) for s in jm.choose_layer_schedules(
        load, 1, ep_size=2, placements=(_jspec(balanced),))]
    ident = (PlacementSpec.identity(E, 2),)
    assert tm.choose_layer_schedules(load, 1, ep_size=2, placements=ident) == plain


# ---------------------------------------------------------------------------
# the trainer: replan cadence, keys, checkpoint round trip
# ---------------------------------------------------------------------------

def _trainers(**kw):
    kw.setdefault("mact_ep_view", 2)
    common = dict(seq_len=32, global_batch=2, lr=1e-3, use_placement=True, **kw)
    return (jtrainer.Trainer(registry()["mixtral-8x7b"].reduced(), jmoe.DistContext(),
                             **common),
            Trainer(get_config("mixtral-8x7b").reduced(), DistContext(device=CPU),
                    **common))


def _skew(tr, n: int = 2):
    E = tr.cfg.moe.num_experts
    return np.tile([100.0, 50.0] + [1.0] * (E - 2), (n, 1))


def _trace(trace) -> list:
    return [{k: v for k, v in rec.items() if k not in ("migrated_bytes", "placements")}
            for rec in trace]


def test_trainer_adopts_placement_as_the_reference():
    jt, tt = _trainers(placement_replicas=1, adaptive_mact=True)
    key0 = tt._next_schedule_key()
    assert key0 == jt._next_schedule_key()
    assert tt._with_placements(key0) == key0        # cold start: identity, bare key
    for tr in (jt, tt):
        tr.telemetry.update(_skew(tr, tr._n_moe))
    key1 = tt._next_schedule_key()
    assert key1 == jt._next_schedule_key()         # tuples of ints, or of NamedTuples
    full = tt._with_placements(key1)
    assert full != key1 and full[0] == key1
    assert all(isinstance(p, PlacementSpec) for p in full[1])
    assert all(_same(a, b) for a, b in zip(tt._placements, jt._placements))
    assert any(not p.is_identity for p in tt._placements)
    assert _trace(tt.placement_trace) == _trace(jt.placement_trace)
    rec = tt.placement_trace[-1]
    assert rec["migrated_slots"] > 0 and rec["migrated_bytes"] > 0
    assert max(rec["imbalance"]) > 1.0
    # the port's bytes: what its weight exchange moves each step, fp32 weights
    foreign = sum(1 for p in tt._placements for s, e in enumerate(p.slot_to_expert)
                  if e // 2 != s // p.slots_per_peer)
    cfg = tt.cfg
    assert rec["migrated_bytes"] == foreign * 3 * cfg.d_model * cfg.moe.d_ff_expert * 4
    # the step's context carries the vector; at one peer it is priced, not run
    ctx = tt._context_for(full)[1]
    assert ctx.placements == tt._placements
    assert (ctx.moe_chunks, ctx.pipeline_chunks) == tt._key_summary(key1)


def test_trainer_respects_replan_interval():
    jt, tt = _trainers(replan_interval=2)
    for tr in (jt, tt):
        tr._next_schedule_key()                         # cold start plan (age 1)
        tr.telemetry.update(_skew(tr, tr._n_moe))
        tr._next_schedule_key()                         # age 1 < 2: no replan yet
    assert all(p.is_identity for p in tt._placements) and len(tt.placement_trace) == 1
    for tr in (jt, tt):
        tr._next_schedule_key()                         # age 2: the replan fires
    assert len(tt.placement_trace) == 2
    assert any(not p.is_identity for p in tt._placements)
    assert all(_same(a, b) for a, b in zip(tt._placements, jt._placements))
    assert _trace(tt.placement_trace) == _trace(jt.placement_trace)


def test_trainer_disabled_or_indivisible_is_none():
    _, tr = _trainers()
    tr.use_placement = False
    assert tr.choose_placements() is None
    _, tr2 = _trainers(mact_ep_view=3)                  # E=4 not divisible by 3
    assert tr2.choose_placements() is None
    assert tr2._with_placements((1, 1)) == (1, 1)


def test_placement_checkpoint_round_trip():
    jt, tt = _trainers(placement_replicas=1, adaptive_mact=True)
    for tr in (jt, tt):
        tr.telemetry.update(_skew(tr, tr._n_moe))
        tr._next_schedule_key()
    extra, jextra = tt._runtime_extra(), jt._runtime_extra()
    assert set(extra) == set(jextra)
    for k in ("telemetry", "placements", "placement_age", "layer_schedules", "plan_age"):
        assert extra[k] == jextra[k], k
    _, tt2 = _trainers(placement_replicas=1, adaptive_mact=True)
    tt2._apply_extra(extra)
    assert tt2._placements == tt._placements
    assert tt2._placement_age == tt._placement_age
    assert tt2._layer_schedules == tt._layer_schedules
    np.testing.assert_array_equal(tt2.telemetry.loads, tt.telemetry.loads)
    # a resumed replan from the warm state is a fixed point
    tt2._placement_age = tt2.replan_interval
    tt2._next_schedule_key()
    assert tt2._placements == tt._placements
