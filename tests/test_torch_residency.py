"""The port's expert-aware serving against the JAX package's, at
``mixtral-8x7b.reduced()`` in fp32, greedy: per-request expert telemetry,
the loads-reporting and masked steps, the router probe, the expert-weight
residency tier and the expert-aware schedulers, on the slot map and on pages.

The cases are the reference's ``tests/test_residency.py``, recast: each one
runs the JAX package and the port on the same carried weights
(``bridge.params_from_jax``).  Integer loads, probe counts, resident sets,
eviction choices and the wave and residency counters must be exactly equal;
logits agree to 1e-4 (fp32 sums in another order); greedy token streams are
equal in every mode, on both caches, and equal the JAX scheduler's.  A
near-tie in routing would show as a differing count, and is not tolerated.

The port's own contracts: the tier writes the weights in place (every
``data_ptr`` stays, ``close`` hands back the original bits), a demand re-run
of an extend chunk that wraps the ring puts back the rows the discarded run
overwrote, members of a masked wave get the unmasked wave's logits bit for
bit, and a build-time placement changes no token.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.configs.base import GPU_64G  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.core.placement import PlacementSpec as JSpec  # noqa: E402
from repro.core.telemetry import ExpertTelemetry as JTelemetry  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import paged_scheduler as jpaged  # noqa: E402
from repro.serving import residency as jres  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro_torch.bridge import layers_in_order, params_from_jax  # noqa: E402
from repro_torch.configs import H100_80G, LayerSpec, get_config  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.core.placement import PlacementSpec  # noqa: E402
from repro_torch.core.telemetry import ExpertTelemetry  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import paged_scheduler as tpaged  # noqa: E402
from repro_torch.serving import residency as tres  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402

CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
JCTX = JCtx()
ARCH = "mixtral-8x7b"
TOL = 1e-4
torch.set_num_threads(min(torch.get_num_threads(), 2))


@pytest.fixture(scope="module")
def models():
    jcfg = jregistry()[ARCH].reduced()
    tcfg = get_config(ARCH).reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX scheduler's runs, each made once per module: key -> (streams,
    metrics, scheduler)."""
    return {}


def _trace(mod, n=6, prompt=6, gen=5, seed=7):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        tokens=rng.integers(1, 100, size=prompt).astype(np.int32),
                        max_new_tokens=gen) for i in range(n)]


def _drive(sched, reqs):
    for r in reqs:
        sched.submit(r)
    n = 0
    while sched.queue or sched.active or sched._prefilling is not None:
        sched.step(float(n))
        n += 1
        assert n < 1000, "scheduler failed to drain"
    return {r.rid: list(r.out) for r in sched.finished}


def _scfg(mod, **kw):
    return mod.ServeConfig(**{"max_slots": 4, "cache_len": 32,
                              "prefill_chunk": 8, **kw})


def _port(models, kw, trace_kw=None, paged=False, ctx=TCTX, hook=None):
    """The port's scheduler on the trace; closed at the end, so the shared
    weights come back whole.  Returns (streams, metrics, scheduler)."""
    _, tcfg, _, tp = models
    cls = tpaged.PagedScheduler if paged else tsch.ContinuousBatchingScheduler
    sched = cls(tp, tcfg, ctx, _scfg(tsch, **kw))
    try:
        if hook is not None:
            hook(sched)
        out = _drive(sched, _trace(tsch, **(trace_kw or {})))
        return out, sched.metrics(1.0), sched
    finally:
        sched.close()


def _recording(store: dict):
    """A ``_port`` hook keeping a copy of every logits row the scheduler
    samples a token from, by (request, token index)."""
    def hook(sched):
        append = sched._append_token

        def rec(req, logits_v, now):
            store[(req.rid, len(req.out))] = np.array(logits_v)
            return append(req, logits_v, now)
        sched._append_token = rec
    return hook


def _bitwise_rows(got: dict, want: dict):
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _jax(models, jax_runs, kw, trace_kw=None, paged=False):
    key = (paged, tuple(sorted(kw.items())), tuple(sorted((trace_kw or {}).items())))
    if key not in jax_runs:
        jcfg, _, jp, _ = models
        cls = jpaged.PagedScheduler if paged else jsch.ContinuousBatchingScheduler
        sched = cls(jp, jcfg, JCTX, _scfg(jsch, **kw))
        out = _drive(sched, _trace(jsch, **(trace_kw or {})))
        jax_runs[key] = (out, sched.metrics(1.0), sched)
    return jax_runs[key]


COUNTERS = ("decode_waves", "prefill_chunks", "max_occupancy", "expert_waves",
            "mean_distinct_experts", "mean_wave_occupancy", "forced_includes",
            "prefetch_hits", "prefetch_misses", "demand_reruns",
            "modeled_peak_bytes", "requeues", "faults")


def _same_run(port, ref):
    (to, tm, _), (jo, jm, _) = port, ref
    assert to == jo
    for key in COUNTERS:
        assert tm[key] == jm[key], key
    assert tm.get("residency") == jm.get("residency")


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense(cfg):
    """A dense-FFN variant of ``cfg`` (either package's config type)."""
    pattern = tuple(dataclasses.replace(s, ffn="dense") for s in cfg.pattern)
    return dataclasses.replace(cfg, moe=None, pattern=pattern, d_ff=512)


# ---------------------------------------------------------------------------
# memory model: the resident-expert weight split
# ---------------------------------------------------------------------------

def test_serve_weight_bytes_resident_split(models):
    jcfg, tcfg, _, _ = models
    E = tcfg.moe.num_experts
    n_moe = ttf.num_moe_layers(tcfg)
    full = tmm.serve_weight_bytes(tcfg)
    per = tmm.expert_weight_bytes(tcfg)
    assert per == 3 * tcfg.d_model * tcfg.moe.d_ff_expert * tmm.WEIGHT_ONLY_BYTES
    assert full == jmm.serve_weight_bytes(jcfg) and per == jmm.expert_weight_bytes(jcfg)
    assert tmm.serve_weight_bytes(tcfg, resident_experts=E) == full
    for r in range(E + 1):
        got = tmm.serve_weight_bytes(tcfg, resident_experts=r)
        assert got == jmm.serve_weight_bytes(jcfg, resident_experts=r)
        np.testing.assert_allclose(got, full - (E - r) * per * n_moe)
    assert tmm.serve_weight_bytes(tcfg, resident_experts=E + 5) == full
    assert tmm.serve_weight_bytes(tcfg, resident_experts=0) > 0


def test_serving_peak_bytes_resident_defaults_unchanged(models):
    jcfg, tcfg, _, _ = models
    kw = dict(requests=3, cache_len=64, decode_tokens=4, prefill_tokens=16)
    base = tmm.serving_peak_bytes(tcfg, **kw)
    assert tmm.serving_peak_bytes(tcfg, resident_experts=None, **kw) == base
    E = tcfg.moe.num_experts
    assert tmm.serving_peak_bytes(tcfg, resident_experts=E,
                                  prefetch_experts=0, **kw) == base
    lo = tmm.serving_peak_bytes(tcfg, resident_experts=2, prefetch_experts=0, **kw)
    assert lo < base
    got = tmm.serving_peak_bytes(tcfg, resident_experts=2, prefetch_experts=1, **kw)
    np.testing.assert_allclose(got - lo, tmm.expert_weight_bytes(tcfg))
    assert got == jmm.serving_peak_bytes(jcfg, resident_experts=2,
                                         prefetch_experts=1, **kw)


def test_dense_arch_resident_kwargs_noop(models):
    jcfg, tcfg, _, _ = models
    kw = dict(requests=2, cache_len=64, decode_tokens=4, prefill_tokens=16)
    dense = _dense(tcfg)
    got = tmm.serving_peak_bytes(dense, resident_experts=2, **kw)
    assert got == tmm.serving_peak_bytes(dense, **kw)
    assert got == jmm.serving_peak_bytes(_dense(jcfg), resident_experts=2, **kw)


# ---------------------------------------------------------------------------
# per-request telemetry
# ---------------------------------------------------------------------------

def test_expert_telemetry_ema_and_support():
    first = np.array([[4.0, 0, 0, 0], [0, 4.0, 0, 0]])
    later = np.array([[0, 0, 4.0, 0], [0, 4.0, 0, 0]])
    both = [ExpertTelemetry(num_layers=2, num_experts=4, decay=0.5),
            JTelemetry(num_layers=2, num_experts=4, decay=0.5)]
    for t in both:
        assert t.loads(0) is None and t.support(0) is None
        assert t.expert_set(0) == frozenset()
        np.testing.assert_array_equal(t.update(0, first), first)
        t.update(0, later)
        np.testing.assert_allclose(t.loads(0), [[2, 0, 2, 0], [0, 4, 0, 0]])
        assert t.expert_set(0) == frozenset({0, 1, 2})
        for _ in range(12):
            t.update(0, later)
        assert t.expert_set(0) == frozenset({1, 2})
    np.testing.assert_array_equal(both[0].loads(0), both[1].loads(0))
    np.testing.assert_array_equal(both[0].support(0), both[1].support(0))
    t = both[0]
    t.forget(0)
    assert t.loads(0) is None
    with pytest.raises(ValueError):
        t.update(1, np.zeros((3, 4)))


# ---------------------------------------------------------------------------
# model plumbing: the loads-reporting steps
# ---------------------------------------------------------------------------

def test_decode_step_return_load_shapes_and_parity(models):
    jcfg, tcfg, jp, tp = models
    n_moe, E = ttf.num_moe_layers(tcfg), tcfg.moe.num_experts
    caches = [teng.init_serve_cache(tp, tcfg, 1, 16) for _ in range(2)]
    toks = torch.tensor([[3]])
    with torch.no_grad():
        lg0, c0 = ttf.decode_step(tp, tcfg, TCTX, caches[0], toks)
        lg1, c1, load = ttf.decode_step(tp, tcfg, TCTX, caches[1], toks,
                                        return_load=True)
    assert load.shape == (n_moe, E) and load.sum() == n_moe * tcfg.moe.top_k
    assert torch.equal(lg0, lg1)
    for a, b in zip(teng.leaves(c0), teng.leaves(c1)):
        assert torch.equal(a, b)
    jcache = jtf.init_cache(jp, jcfg, 1, 16, jnp.float32)
    jlg, _, jload = jtf.decode_step(jp, jcfg, JCTX, jcache, jnp.array([[3]], jnp.int32),
                                    return_load=True)
    np.testing.assert_array_equal(_np(load), np.asarray(jload))
    np.testing.assert_allclose(_np(lg1), np.asarray(jlg), rtol=TOL, atol=TOL)


def test_prefill_and_extend_steps_report_load_parity(models):
    """The prefill and extend steps return the chunk's (L_moe, E) load
    beside what ``prefill_chunk`` returns, equal to the reference's
    ``prefill_chunk(return_load=True)``."""
    jcfg, tcfg, jp, tp = models
    n_moe, E = ttf.num_moe_layers(tcfg), tcfg.moe.num_experts
    seg, seg2 = [[1, 2, 3, 4]], [[5, 6]]
    t = lambda a: torch.tensor(a)  # noqa: E731
    lg0, c0 = teng.prefill_chunk(tp, tcfg, TCTX, None, t(seg), 16)
    lg1, c1, load = teng.get_prefill_fn(tcfg, TCTX, 16)(tp, {"tokens": t(seg)})
    assert load.shape == (n_moe, E) and torch.equal(lg0, lg1)
    full, c1, load2 = teng.get_extend_step(tcfg, TCTX)(tp, c1, t(seg2))
    lg2 = full[:, -1:]
    lg3, c0 = teng.prefill_chunk(tp, tcfg, TCTX, c0, t(seg2), 16)
    assert load2.shape == (n_moe, E) and torch.equal(lg2, lg3)
    j = jnp.asarray
    jlg1, jc1, jload = jeng.prefill_chunk(jp, jcfg, JCTX, None, j(seg, jnp.int32), 16,
                                          return_load=True)
    jlg2, _, jload2 = jeng.prefill_chunk(jp, jcfg, JCTX, jc1, j(seg2, jnp.int32), 16,
                                         return_load=True)
    np.testing.assert_array_equal(_np(load), np.asarray(jload))
    np.testing.assert_array_equal(_np(load2), np.asarray(jload2))
    np.testing.assert_allclose(_np(lg2), np.asarray(jlg2), rtol=TOL, atol=TOL)


def test_masked_decode_full_mask_bitwise_and_nonmember_frozen(models):
    jcfg, tcfg, jp, tp = models
    S = 3
    masked = teng.get_decode_step_masked(tcfg, TCTX)
    jmasked = jeng.get_decode_step_masked(jcfg, JCTX)
    one = jtf.init_cache(jp, jcfg, 1, 16, jnp.float32)
    jcache = jax.tree.map(lambda l: jnp.broadcast_to(l[None], (S,) + l.shape), one)
    full, part = (teng.init_serve_cache(tp, tcfg, S, 16) for _ in range(2))
    # two unmasked waves first, so the masked one runs on a filled cache
    for step, toks in enumerate(([[5], [6], [7]], [[8], [9], [10]])):
        t = torch.tensor(toks)
        lg, full = ttf.decode_step(tp, tcfg, TCTX, full, t)
        lg_m, part, load = masked(tp, part, t, torch.ones(S, dtype=torch.bool))
        assert torch.equal(lg, lg_m)
        for a, b in zip(teng.leaves(full), teng.leaves(part)):
            assert torch.equal(a, b)
        jlg, jcache, jload = jmasked(jp, jcache, jnp.asarray(toks, jnp.int32)[:, :, None],
                                     jnp.ones((S,), bool))
        np.testing.assert_array_equal(_np(load), np.asarray(jload))
    before = [t.clone() for t in teng.leaves(part)]
    toks = torch.tensor([[11], [12], [13]])
    lg_full, full = ttf.decode_step(tp, tcfg, TCTX, full, toks)
    mask = torch.tensor([True, False, True])
    lg_p, part, load = masked(tp, part, toks, mask)
    assert torch.equal(lg_p[0], lg_full[0]) and torch.equal(lg_p[2], lg_full[2])
    for a, b in zip(teng.leaves(part), before):
        assert torch.equal(a[1], b[1])                 # non-member untouched
    assert part["pos"].tolist() == [3, 2, 3]
    assert torch.equal(load[1], torch.zeros_like(load[1]))
    jlg, _, jload = jmasked(jp, jcache, jnp.asarray(_np(toks), jnp.int32)[:, :, None],
                            jnp.asarray(_np(mask)))
    np.testing.assert_array_equal(_np(load), np.asarray(jload))
    np.testing.assert_allclose(_np(lg_p)[[0, 2]], np.asarray(jlg)[[0, 2], 0],
                               rtol=TOL, atol=TOL)


def test_router_probe_equals_the_reference(models):
    jcfg, tcfg, jp, tp = models
    n_moe, E = ttf.num_moe_layers(tcfg), tcfg.moe.num_experts
    counts = _np(teng.get_router_probe(tcfg, TCTX)(tp, torch.arange(1, 6)))
    assert counts.shape == (5, n_moe, E)
    np.testing.assert_array_equal(counts.sum(-1), np.full((5, n_moe), tcfg.moe.top_k))
    jcounts = jeng.get_router_probe(jcfg, JCTX)(jp, jnp.arange(1, 6, dtype=jnp.int32))
    np.testing.assert_array_equal(counts, np.asarray(jcounts))


# ---------------------------------------------------------------------------
# residency manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "deepseek-mini-16l", "jamba-1.5-large-398b"])
def test_moe_layer_refs_map_onto_the_reference(arch):
    """The reference's (head, index, period) refs, mapped through
    ``bridge.layers_in_order``, are the port's flat layer indices, on
    configs with a prefix, scanned periods and a remainder."""
    jcfg = jregistry()[arch].reduced()
    tcfg = dataclasses.replace(
        get_config(ARCH).reduced(), num_layers=jcfg.num_layers,
        prefix=tuple(LayerSpec(ffn=s.ffn) for s in jcfg.prefix),
        pattern=tuple(LayerSpec(ffn=s.ffn) for s in jcfg.pattern))
    refs = tres.moe_layer_refs(tcfg)
    jrefs = jres.moe_layer_refs(jcfg)
    assert len(refs) == len(jrefs) == jtf.num_moe_layers(jcfg) == ttf.num_moe_layers(tcfg)
    jp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg))
    flat = layers_in_order(jp, jcfg)
    for i, (head, idx, p) in zip(refs, jrefs):
        want = jp[head][idx]["ffn"]["w1"]
        want = want[p] if p is not None else want
        assert "router" in flat[i]["ffn"]
        np.testing.assert_array_equal(flat[i]["ffn"]["w1"], want)


def test_offload_restore_in_place_and_bitwise(models):
    """The port's in-place contract: offload and restore keep every
    weight's ``data_ptr``, cold rows read zero, ``close`` restores the
    original bits and releases the mirror."""
    _, tcfg, _, tp = models
    E, n_moe = tcfg.moe.num_experts, ttf.num_moe_layers(tcfg)
    flat0 = [t.clone() for t in teng.leaves(tp)]
    ptrs = [t.data_ptr() for t in teng.leaves(tp)]
    res = tres.ExpertResidency(tp, tcfg, capacity=2)
    try:
        w1 = tp["layers"][res.refs[0]]["ffn"]["w1"]
        w1_0 = w1.clone()
        res.offload_cold(tp)
        assert res.offloads == (E - 2) * n_moe
        assert [t.data_ptr() for t in teng.leaves(tp)] == ptrs
        assert not w1[E - 1].any() and torch.equal(w1[0], w1_0[0])
        res.ensure(tp, [(0, E - 1)])
        assert torch.equal(w1[E - 1], w1_0[E - 1])
        assert [t.data_ptr() for t in teng.leaves(tp)] == ptrs
    finally:
        res.close(tp)
    assert res.host is None
    for a, b in zip(flat0, teng.leaves(tp)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in teng.leaves(tp)] == ptrs
    res.close(tp)                                       # idempotent


def test_residency_missing_and_heat_eviction(models):
    jcfg, tcfg, jp, tp = models
    E, n_moe = tcfg.moe.num_experts, ttf.num_moe_layers(tcfg)
    res = tres.ExpertResidency(tp, tcfg, capacity=2)
    jr = jres.ExpertResidency(jp, jcfg, capacity=2)
    try:
        res.offload_cold(tp)
        jpp = jr.offload_cold(jp)
        act = np.zeros((n_moe, E), bool)
        act[0, E - 1] = True
        assert res.missing(act) == jr.missing(act) == [(0, E - 1)]
        res.ensure(tp, res.missing(act), demand=True)
        jpp = jr.ensure(jpp, jr.missing(act), demand=True)
        assert res.demand_restores == 1 and res.missing(act) == []
        assert res.hwm_experts == 3
        heat = np.zeros((n_moe, E))
        heat[:, E - 1] = 10.0
        res.note(heat)
        jr.note(heat)
        res.evict_to_capacity(tp)
        jpp = jr.evict_to_capacity(jpp)
        assert all(len(s) == 2 for s in res.resident)
        assert (E - 1) in res.resident[0] and 0 not in res.resident[0]
        assert res.resident == jr.resident and res.stats() == jr.stats()
    finally:
        res.close(tp)


def test_always_resident_never_evicted(models):
    jcfg, tcfg, jp, tp = models
    E, n_moe = tcfg.moe.num_experts, ttf.num_moe_layers(tcfg)
    always = [frozenset({E - 1})] * n_moe
    res = tres.ExpertResidency(tp, tcfg, capacity=2, always_resident=always)
    jr = jres.ExpertResidency(jp, jcfg, capacity=2, always_resident=always)
    try:
        res.offload_cold(tp)
        jpp = jr.offload_cold(jp)
        assert all(E - 1 in s for s in res.resident)
        heat = np.ones((n_moe, E)) * 10.0
        heat[:, E - 1] = 0.0
        pred = np.zeros((n_moe, E), bool)
        pred[:, 0] = True
        for r, p in ((res, tp), (jr, jpp)):
            r.note(heat)
        res.prefetch(tp, pred)
        jr.prefetch(jpp, pred)
        assert all(E - 1 in s for s in res.resident)
        assert res.resident == jr.resident and res.stats() == jr.stats()
    finally:
        res.close(tp)
    with pytest.raises(ValueError):
        tres.ExpertResidency(tp, tcfg, capacity=1,
                             always_resident=[frozenset({0, 1})] * n_moe)


def test_residency_decisions_equal_the_reference(models):
    """A random sequence of prefetches, demand misses, heat updates and
    evictions: resident sets, ``missing`` lists, stats and the weights
    themselves equal the reference's at every step."""
    jcfg, tcfg, jp, tp = models
    E, n_moe = tcfg.moe.num_experts, ttf.num_moe_layers(tcfg)
    rng = np.random.default_rng(3)
    res = tres.ExpertResidency(tp, tcfg, capacity=2)
    jr = jres.ExpertResidency(jp, jcfg, capacity=2)
    try:
        res.offload_cold(tp)
        jpp = jr.offload_cold(jp)
        for _ in range(12):
            pred = rng.random((n_moe, E)) < 0.3
            res.prefetch(tp, pred)
            jpp = jr.prefetch(jpp, pred)
            act = rng.random((n_moe, E)) < 0.5
            miss = res.missing(act)
            assert miss == jr.missing(act)
            res.ensure(tp, miss, demand=True)
            jpp = jr.ensure(jpp, miss, demand=True)
            load = rng.integers(0, 6, (n_moe, E)).astype(float)
            res.note(load)
            jr.note(load)
            res.evict_to_capacity(tp)
            jpp = jr.evict_to_capacity(jpp)
            assert res.resident == jr.resident and res.stats() == jr.stats()
        np.testing.assert_array_equal(res.heat, jr.heat)
        flat = layers_in_order(jax.tree.map(np.asarray, jpp), jcfg)
        for j, i in enumerate(res.refs):
            for name in tres.EXPERT_LEAVES:
                np.testing.assert_array_equal(_np(tp["layers"][i]["ffn"][name]),
                                              flat[i]["ffn"][name])
    finally:
        res.close(tp)


def test_always_resident_sets_from_placements():
    E = 4
    for spec_cls, mod in ((PlacementSpec, tres), (JSpec, jres)):
        ident = spec_cls.identity(E, 1)
        repl = spec_cls(num_experts=E, num_peers=1, slot_to_expert=(0, 1, 2, 3, 2))
        assert mod.always_resident_sets((ident, repl), 2, E) == [frozenset(),
                                                                 frozenset({2})]
        assert mod.always_resident_sets(None, 2, E) == [frozenset()] * 2
        with pytest.raises(ValueError):
            mod.always_resident_sets((ident,), 2, E)


# ---------------------------------------------------------------------------
# scheduler: wave formation and end-to-end parity
# ---------------------------------------------------------------------------

def test_expert_aware_rejects_dense_arch(models):
    _, tcfg, _, _ = models
    dense = _dense(tcfg)
    params = ttf.init_params(dense, device=CPU)
    with pytest.raises(ValueError, match="dense"):
        tsch.ContinuousBatchingScheduler(params, dense, TCTX,
                                         _scfg(tsch, expert_batching=True))


SLOT_MODES = ({}, {"wave_size": 2}, {"wave_size": 2, "expert_batching": True},
              {"wave_size": 2, "expert_batching": True, "resident_experts": 2},
              {"expert_batching": True, "resident_experts": 2, "probe_router": True})
PAGED_MODES = ({"page_size": 8},
               {"page_size": 8, "wave_size": 2, "expert_batching": True},
               {"page_size": 8, "wave_size": 2, "expert_batching": True,
                "resident_experts": 2},
               {"page_size": 8, "expert_batching": True, "resident_experts": 2,
                "prefix_cache": True})


@pytest.mark.parametrize("mode", range(len(SLOT_MODES)))
def test_slot_map_modes_equal_the_reference(models, jax_runs, mode):
    """Wave composition is a scheduling choice: every mode emits the
    default run's tokens, and the JAX scheduler's, with its counters."""
    kw = SLOT_MODES[mode]
    rows, base = {}, {}
    port = _port(models, kw, hook=_recording(rows))
    _same_run(port, _jax(models, jax_runs, kw))
    assert port[0] == _port(models, {}, hook=_recording(base))[0]
    assert all(len(v) == 5 for v in port[0].values())
    # a member's logits do not depend on the wave's other rows, and a clean
    # run after demand restores equals the all-resident one: bit for bit
    _bitwise_rows(rows, base)


@pytest.mark.parametrize("mode", range(len(PAGED_MODES)))
def test_paged_modes_equal_the_reference(models, jax_runs, mode):
    kw = PAGED_MODES[mode]
    rows, base = {}, {}
    port = _port(models, kw, paged=True, hook=_recording(rows))
    _same_run(port, _jax(models, jax_runs, kw, paged=True))
    assert port[0] == _port(models, {}, hook=_recording(base))[0]  # == slot map
    _bitwise_rows(rows, base)
    m = port[1]
    assert m["requeues"] == 0 and m["shed"] == 0
    if "residency" in m:
        assert m["residency"]["restores"] >= m["residency"]["demand_restores"]


def _starve(mod, make, E, n_moe):
    """The reference's starvation-guard drive: a first run, then on a fresh
    scheduler from ``make`` (where the reference resets its one) four
    residents with pinned EMAs (three share experts {0, 1}, the victim owns
    {2, 3}) and pure decode waves.  Returns (first run's streams, forced
    includes, the victim advanced, streams after the guard)."""
    out = _drive(make(), _trace(mod, n=4, gen=12))
    sched = make()
    for r in _trace(mod, n=4, gen=12):
        sched.submit(r)
    while len(sched.active) < 4:
        sched.step(0.0)
    rids = [sched.active[s].rid for s in sorted(sched.active)]
    shared, loner = np.zeros((n_moe, E)), np.zeros((n_moe, E))
    shared[:, :2] = 5.0
    loner[:, 2:4] = 5.0
    for rid in rids[:3]:
        for _ in range(8):
            sched.telemetry.update(rid, shared)
    for _ in range(8):
        sched.telemetry.update(rids[3], loner)
    victim = [r for r in sched.active.values() if r.rid == rids[3]][0]
    before = len(victim.out)
    sched.forced_includes = 0
    for i in range(2 * (sched.scfg.max_wave_wait + 1)):
        if not sched.active:
            break
        sched.step(float(i + 1))
    forced = sched.forced_includes
    advanced = len(victim.out) > before or victim.state == "finished"
    while sched.queue or sched.active or sched._prefilling is not None:
        sched.step(99.0)
    return out, forced, advanced, {r.rid: list(r.out) for r in sched.finished}


def test_starvation_guard_forces_inclusion(models):
    jcfg, tcfg, jp, tp = models
    E, n_moe = tcfg.moe.num_experts, ttf.num_moe_layers(tcfg)
    kw = dict(wave_size=2, expert_batching=True, max_wave_wait=1)
    port = _starve(tsch, lambda: tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, _scfg(tsch, **kw)), E, n_moe)
    ref = _starve(jsch, lambda: jsch.ContinuousBatchingScheduler(
        jp, jcfg, JCTX, _scfg(jsch, **kw)), E, n_moe)
    out, forced, advanced, after = port
    assert forced > 0 and advanced and after == out
    assert port == ref


def test_wave_metrics_reported(models, jax_runs):
    _, tcfg, _, _ = models
    kw = dict(wave_size=2, expert_batching=True, resident_experts=2)
    _, m, _ = _port(models, kw)
    for key in ("expert_waves", "mean_distinct_experts", "mean_wave_occupancy",
                "forced_includes", "prefetch_hits", "prefetch_misses",
                "demand_reruns", "residency"):
        assert key in m, key
    assert m["expert_waves"] > 0
    assert 0 < m["mean_distinct_experts"] <= tcfg.moe.num_experts
    assert 0 < m["mean_wave_occupancy"] <= 2
    assert m["residency"]["resident_experts_hwm"] >= 2
    assert m["residency"] == _jax(models, jax_runs, kw)[1]["residency"]
    _, mp, _ = _port(models, {})
    assert mp["expert_waves"] == 0 and "residency" not in mp


def test_admission_parity_when_residency_off(models):
    jcfg, tcfg, jp, tp = models
    a = tsch.ContinuousBatchingScheduler(tp, tcfg, TCTX, _scfg(tsch))
    b = tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, _scfg(tsch, wave_size=2, expert_batching=True))
    for n in (1, 2, 4):
        assert a.modeled_bytes(n) == b.modeled_bytes(n)
        assert a._admissible(n) == b._admissible(n)
    c = tsch.ContinuousBatchingScheduler(tp, tcfg, TCTX,
                                         _scfg(tsch, resident_experts=2))
    try:
        assert c.modeled_bytes(2) < a.modeled_bytes(2)
        jc = jsch.ContinuousBatchingScheduler(jp, jcfg, JCTX,
                                              _scfg(jsch, resident_experts=2))
        assert c.modeled_bytes(2) == jc.modeled_bytes(2)
    finally:
        c.close()


def test_residency_admits_more_at_equal_budget(models):
    jcfg, tcfg, jp, tp = models
    kw = dict(cache_len=64, decode_tokens=8, prefill_tokens=8, dtype_bytes=2)
    lo = tmm.serving_peak_bytes(tcfg, requests=2, **kw)
    hi = tmm.serving_peak_bytes(tcfg, requests=3, **kw)
    assert (lo, hi) == (jmm.serving_peak_bytes(jcfg, requests=2, **kw),
                        jmm.serving_peak_bytes(jcfg, requests=3, **kw))
    runs = {}
    for name, mod, hw0, params, cfg, ctx in (
            ("port", tsch, H100_80G, tp, tcfg, TCTX),
            ("jax", jsch, GPU_64G, jp, jcfg, JCTX)):
        hw = dataclasses.replace(hw0, hbm_bytes=(lo + hi) / 2, alpha=1.0)
        for res in (0, 2):
            # the port's prefetch buffer is the constant PREFETCH_EXPERTS
            prefetch = {} if name == "port" else {"prefetch_experts": 1}
            sched = mod.ContinuousBatchingScheduler(
                params, cfg, ctx, mod.ServeConfig(
                    max_slots=8, cache_len=64, prefill_chunk=8, hw=hw,
                    resident_experts=res, **prefetch))
            out = _drive(sched, _trace(mod, n=8))
            runs[name, res] = (out, len(sched.finished), sched.max_occupancy,
                               sched.modeled_peak)
            if name == "port":
                sched.close()
            assert sched.modeled_peak <= hw.alpha * hw.hbm_bytes
    full, res = runs["port", 0], runs["port", 2]
    assert full[0] == res[0] and res[1] == 8
    assert res[2] > full[2]
    assert runs["port", 0] == runs["jax", 0] and runs["port", 2] == runs["jax", 2]


def test_probe_router_output_invariance(models, jax_runs):
    kw = dict(expert_batching=True, resident_experts=2)
    plain = _port(models, kw)
    probed = _port(models, dict(probe_router=True, **kw))
    assert plain[0] == probed[0]
    _same_run(plain, _jax(models, jax_runs, kw))


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def test_demand_rerun_in_a_wrapped_chunk_puts_the_ring_back(models, jax_runs,
                                                           monkeypatch):
    """A window shorter than the prompt: the third 32-token chunk of a
    96-token prompt wraps the 64-slot ring, overwriting rows its own
    earlier queries still see.  With one resident expert per layer nearly
    every run misses, so that chunk is re-run after a demand restore: the
    rows the discarded run overwrote must be put back first, and the
    streams equal the all-resident run's and the JAX scheduler's."""
    window = models[1].pattern[0].attn.window
    wrapped = []
    rewind = teng.rewind_chunk

    def recording(cache, snap):
        C = snap[1][0][0].shape[1]
        wrapped.append(int(snap[0][0]) + C > window)
        rewind(cache, snap)

    monkeypatch.setattr(teng, "rewind_chunk", recording)
    trace_kw = dict(n=3, prompt=96, gen=6)
    kw = dict(cache_len=128, prefill_chunk=32, max_slots=2, resident_experts=1)
    rows, base_rows = {}, {}
    port = _port(models, kw, trace_kw, hook=_recording(rows))
    assert any(wrapped), "no demand re-run of a chunk that wraps the ring"
    base = _port(models, dict(cache_len=128, prefill_chunk=32, max_slots=2),
                 trace_kw, hook=_recording(base_rows))
    assert port[0] == base[0]
    _bitwise_rows(rows, base_rows)
    _same_run(port, _jax(models, jax_runs, kw, trace_kw))


def test_build_placements_price_and_change_no_token(models):
    """Placement under serving is priced and names the always-resident
    experts; it moves nothing, so the streams equal the unplaced run's."""
    jcfg, tcfg, _, _ = models
    n_moe, E = ttf.num_moe_layers(tcfg), tcfg.moe.num_experts
    loads = np.ones((n_moe, E))
    loads[:, 1] = 50.0
    ctx, replica = teng.build_placements(tcfg, TCTX, 2, loads=loads, replicas=1)
    jctx, jreplica = jeng.build_placements(jcfg, JCTX, 2, loads=loads, replicas=1)
    assert replica == jreplica > 0
    assert [tuple(p) for p in ctx.placements] == [tuple(p) for p in jctx.placements]
    assert teng.build_placements(tcfg, TCTX, 1, loads=loads) == (TCTX, 0.0)
    hot = tres.always_resident_sets(ctx.placements, n_moe, E)
    assert all(1 in s for s in hot)
    kw = dict(wave_size=2, expert_batching=True, resident_experts=2,
              replica_weight_bytes=replica)
    residents = []
    placed = _port(models, kw, ctx=ctx,
                   hook=lambda s: residents.append(s.residency))
    assert residents[0].always == hot
    assert all(1 in s for s in residents[0].resident)
    assert placed[0] == _port(models, {})[0]
    plain = _port(models, dict(kw, replica_weight_bytes=0.0))
    assert placed[1]["modeled_peak_bytes"] == plain[1]["modeled_peak_bytes"] + replica


def test_residency_scheduler_close_restores_shared_weights(models):
    """Two schedulers share one ``params``: while the tiered one lives the
    weights are partly zero, and ``close`` hands them back bit for bit."""
    _, tcfg, _, tp = models
    flat0 = [t.clone() for t in teng.leaves(tp)]
    sched = tsch.ContinuousBatchingScheduler(tp, tcfg, TCTX,
                                             _scfg(tsch, resident_experts=1))
    assert any(not torch.equal(a, b) for a, b in zip(flat0, teng.leaves(tp)))
    _drive(sched, _trace(tsch, n=2))
    sched.close()
    sched.close()
    for a, b in zip(flat0, teng.leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("paged", [False, True])
def test_second_open_tier_on_shared_weights_raises(models, paged):
    """A second tiered scheduler on weights an open tier writes would mirror
    that tier's zeroed rows as the true bits: it raises, and once the
    first closes, a new one opens on the whole weights."""
    _, tcfg, _, tp = models
    cls = tpaged.PagedScheduler if paged else tsch.ContinuousBatchingScheduler
    page = dict(page_size=8) if paged else {}
    flat0 = [t.clone() for t in teng.leaves(tp)]
    w1 = tp["layers"][tres.moe_layer_refs(tcfg)[0]]["ffn"]["w1"]
    first = cls(tp, tcfg, TCTX, _scfg(tsch, resident_experts=1, **page))
    try:
        assert not w1[-1].any()
        with pytest.raises(RuntimeError, match="another open expert-residency"):
            cls(tp, tcfg, TCTX, _scfg(tsch, resident_experts=2, **page))
        plain = cls(tp, tcfg, TCTX, _scfg(tsch, wave_size=2, **page))
        plain.close()                   # no tier: shares the weights freely
    finally:
        first.close()
    second = cls(tp, tcfg, TCTX, _scfg(tsch, resident_experts=2, **page))
    try:
        assert torch.equal(second.residency.host[0]["w1"], flat0[
            [t is w1 for t in teng.leaves(tp)].index(True)])
    finally:
        second.close()
    for a, b in zip(flat0, teng.leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("paged", [False, True])
def test_decode_demand_rerun_rewinds_the_wave(models, paged):
    """With the prefetch switched off and one resident expert per layer,
    decode waves miss and re-run: the slot map puts back the positions the
    discarded run advanced (the paged wave rewrites the same rows).  Every
    sampled logits row equals the all-resident run's bit for bit, and the
    run equals the JAX scheduler's with the same prefetch switched off."""
    jcfg, _, jp, _ = models
    kw = dict(resident_experts=1, wave_size=2, **({"page_size": 8} if paged else {}))
    decode_reruns = []

    def no_prefetch(sched):
        sched.residency.prefetch = lambda params, predicted: None
        wave = sched._decode_wave_expert

        def counted(now):
            before = sched.demand_reruns
            wave(now)
            decode_reruns.append(sched.demand_reruns - before)
        sched._decode_wave_expert = counted

    rows, base = {}, {}
    port = _port(models, kw, paged=paged,
                 hook=lambda s: (no_prefetch(s), _recording(rows)(s)))
    assert sum(decode_reruns) > 0, "no decode wave re-ran"
    assert port[0] == _port(models, {}, hook=_recording(base))[0]
    _bitwise_rows(rows, base)
    cls = jpaged.PagedScheduler if paged else jsch.ContinuousBatchingScheduler
    js = cls(jp, jcfg, JCTX, _scfg(jsch, **kw))
    js.residency.prefetch = lambda params, predicted: params
    _same_run(port, (_drive(js, _trace(jsch)), js.metrics(1.0), js))
