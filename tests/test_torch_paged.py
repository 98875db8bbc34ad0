"""The port's paged serving path against the JAX package's at
``mixtral-8x7b.reduced()`` in fp32, greedy.

The port's ``PagedScheduler`` and the JAX ``PagedScheduler`` serve the same
trace from the same weights (``bridge.params_from_jax``): token streams,
admission order, decode waves, prefill chunks, preemptions, faults,
requeues, ``page_hwm_bytes``, the modeled peak and the prefix statistics
must be exactly equal, and the allocator must audit clean and drain.  The
cases are the reference's ``tests/test_paging.py`` and the paged fault
cases of ``tests/test_runtime.py``, recast on Mixtral where the reference
uses another architecture for a mechanism that is not specific to it
(a page size that does not divide ``cache_len``, prefix hits, the pool's
spill round trip).  Mixtral's 64-token window makes every cache of 64 or
more tokens a ring.

The port's own contracts, bit for bit (``torch.equal``): paged decode
logits against the slot map's, an adopted prefix cache against the cold
chunked prefill's, a spill and restore round trip, and the gather and
scatter primitives against the reference's.  No tolerance anywhere: every
compared quantity is an integer, a token or an fp32 value expected
bit-equal.
"""

import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import GPU_64G  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime.faults import FaultInjector as JInjector  # noqa: E402
from repro.serving import paged_scheduler as jpaged  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import H100_80G, get_config  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.runtime.faults import FaultInjector  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import paged_scheduler as tpaged  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402
from repro_torch.serving.paged_cache import PagedCachePool  # noqa: E402
from repro_torch.serving.paging import SCRATCH_PAGE, ZERO_PAGE  # noqa: E402

CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
torch.set_num_threads(min(torch.get_num_threads(), 2))


@pytest.fixture(scope="module")
def models():
    jcfg = registry()["mixtral-8x7b"].reduced()
    tcfg = get_config("mixtral-8x7b").reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _trace(mod, vocab, shapes, seed=0, stem=None):
    """``mod``'s Requests; shapes: (prompt_len, gen[, priority]); ``stem``
    prepends a shared prefix to every prompt."""
    rng = np.random.default_rng(seed)
    out = []
    for i, sh in enumerate(shapes):
        S, g, prio = (tuple(sh) + (0,))[:3]
        toks = rng.integers(0, vocab, S).astype(np.int32)
        if stem is not None:
            toks = np.concatenate([stem, toks])
        out.append(mod.Request(rid=i, tokens=toks, max_new_tokens=g,
                               arrival=0.0, priority=prio))
    return out


def _stem(vocab, n, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(0, vocab, n).astype(np.int32) if n else None


def _hw(mod_hw, budget):
    return dataclasses.replace(mod_hw, hbm_bytes=budget, alpha=1.0)


def _pair(models, scfg_kw, trace_fn, *, jinj=None, tinj=None, budget=None):
    """The same trace through the JAX and the port's PagedScheduler; returns
    ((jax scheduler, metrics), (port scheduler, metrics))."""
    jcfg, tcfg, jp, tp = models
    jkw, tkw = dict(scfg_kw), dict(scfg_kw)
    if budget is not None:
        jkw["hw"], tkw["hw"] = _hw(GPU_64G, budget), _hw(H100_80G, budget)
    js = jpaged.PagedScheduler(jp, jcfg, JCtx(), jsch.ServeConfig(**jkw),
                               key=jax.random.PRNGKey(1), injector=jinj)
    ts = tpaged.PagedScheduler(tp, tcfg, TCTX, tsch.ServeConfig(**tkw),
                               injector=tinj)
    return ((js, js.run(trace_fn(jsch))), (ts, ts.run(trace_fn(tsch))))


COUNTS = ("requests", "generated_tokens", "decode_waves", "prefill_chunks",
          "max_occupancy", "shed", "requeues", "faults", "preemptions",
          "prefix_evictions", "page_hwm_bytes", "page_allocated_bytes",
          "modeled_peak_bytes")


def _streams(sched) -> dict:
    return {r.rid: list(r.out) for r in sched.finished}


def _assert_same(jrun, trun):
    (js, jm), (ts, tm) = jrun, trun
    assert _streams(ts) == _streams(js)
    assert ts.admission_order == js.admission_order
    for key in COUNTS + tuple(k for k in jm if k.startswith("prefix_")):
        assert tm[key] == jm[key], key
    assert tm["nonfinite_logits"] == 0
    assert {r.rid: r.preemptions for r in ts.finished} == \
        {r.rid: r.preemptions for r in js.finished}


def _drained(sched):
    """The allocator audits clean and drains once the trie lets go."""
    sched.pool.alloc.audit()
    if sched.trie is not None:
        sched.trie.clear()
    for key in sched.pool.alloc.spaces:
        assert sched.pool.alloc.allocated(key) == 0, f"space {key} leaked"


def _slot_map_streams(models, shapes, cache_len, chunk=8, slots=3, stem=None):
    _, tcfg, _, tp = models
    sched = tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=slots, cache_len=cache_len,
                                         prefill_chunk=chunk))
    sched.run(_trace(tsch, tcfg.vocab_size, shapes, stem=stem))
    return _streams(sched)


# ---------------------------------------------------------------------------
# the scheduler against the JAX package's
# ---------------------------------------------------------------------------

CASES = {
    # window-64 ring wrapping at a page boundary (64 = 8 pages): prompt 72
    # wraps during prefill, decode keeps wrapping (test_paging.py MATRIX)
    "ring_wraps_in_prefill": (96, [(72, 10), (16, 6)], 0, False, 3),
    # a trailing partial page: 44 = 5.5 pages of 8, a linear cache
    "page_not_dividing_cache_len": (44, [(16, 5), (20, 4)], 0, False, 3),
    # a 16-token system prompt shared by 4 requests: later admissions skip
    # its chunks and still match the cold slot map
    "prefix_hit_equals_cold": (48, [(8, 5)] * 4, 16, True, 3),
    # decode-time CoW: request 1 adopts request 0's 32-token prompt and
    # generates past the 64-token ring, wrapping into adopted pages
    "prefix_ring_wrap_cow": (96, [(0, 4), (0, 40)], 32, True, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_paged_scheduler_equals_the_reference(models, case):
    cache_len, shapes, stem_len, prefix, slots = CASES[case]
    vocab = models[0].vocab_size
    stem = _stem(vocab, stem_len)
    jrun, trun = _pair(
        models, dict(max_slots=slots, cache_len=cache_len, prefill_chunk=8,
                     page_size=8, prefix_cache=prefix),
        lambda mod: _trace(mod, vocab, shapes, stem=stem))
    _assert_same(jrun, trun)
    ts, tm = trun
    assert _streams(ts) == _slot_map_streams(models, shapes, cache_len,
                                             slots=slots, stem=stem)
    assert tm["page_hwm_bytes"] > 0
    if case == "prefix_hit_equals_cold":
        assert tm["prefix_hits"] >= 3 and tm["prefix_tokens_reused"] > 0
        assert tm["prefix_hit_rate"] > 0.5
    if case == "prefix_ring_wrap_cow":
        assert tm["prefix_tokens_reused"] > 0
    _drained(ts)
    _drained(jrun[0])


def _tight_budget(models, shapes, chunk=8):
    """A budget admitting ~2 worst-case requests of the largest shape, the
    reference's ``_tight_budget``: equal in both packages."""
    jcfg, tcfg, _, tp = models
    probe = tpaged.PagedScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=4, cache_len=32,
                                         prefill_chunk=chunk, page_size=8))
    per_req = max(probe.pool.ops.worst_case_bytes(S + g) for S, g in shapes)
    base = jmm.serving_paged_peak_bytes(jcfg, page_bytes=0, decode_tokens=4,
                                        prefill_tokens=chunk)
    return base + 2.2 * per_req


PREEMPT_SHAPES = [(16, 12, 0), (16, 4, 1), (16, 4, 1), (16, 4, 1)]
PREEMPT_SCFG = dict(max_slots=4, cache_len=32, prefill_chunk=8, page_size=8,
                    preemption=True)


def test_preemption_spill_restore_equals_the_reference(models):
    """Under a 2-request budget the low-priority resident is spilled for the
    high-priority arrivals and restored later: its output matches a run
    never preempted, and the JAX scheduler's counters."""
    vocab = models[0].vocab_size
    budget = _tight_budget(models, [(16, 12), (16, 4)])
    jrun, trun = _pair(models, PREEMPT_SCFG,
                       lambda mod: _trace(mod, vocab, PREEMPT_SHAPES),
                       budget=budget)
    _assert_same(jrun, trun)
    ts, tm = trun
    assert tm["preemptions"] >= 1 and tm["shed"] == 0
    assert tm["requests"] == len(PREEMPT_SHAPES)
    assert tm["modeled_peak_bytes"] <= tm["budget_bytes"]
    assert next(r for r in ts.finished if r.rid == 0).preemptions >= 1
    assert _streams(ts) == _slot_map_streams(
        models, [s[:2] for s in PREEMPT_SHAPES], 32, slots=4)
    _drained(ts)


# ---------------------------------------------------------------------------
# faults mid-preemption, mid-CoW, and a chaos run (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def _steps_at(sched, trace, method):
    """Scheduler steps at which ``method`` of ``sched`` was called in a
    dry run of ``trace``."""
    steps, orig = [], getattr(type(sched), method)

    def rec(self, *a, **k):
        steps.append(self.steps)
        return orig(self, *a, **k)

    setattr(sched, method, types.MethodType(rec, sched))
    sched.run(trace)
    return steps


def test_fault_mid_preemption_equals_the_reference(models):
    """An injected OOM at the preemption spill's fault point (after the host
    copy, before any reference drops) aborts the spill with the victim
    resident and the allocator intact; the preemption retries once the
    injector disarms.  The same step, counters and streams as the JAX
    scheduler."""
    jcfg, tcfg, jp, tp = models

    def trace(mod):
        rng = np.random.default_rng(5)
        return [mod.Request(rid=i, tokens=rng.integers(0, jcfg.vocab_size,
                                                       16).astype(np.int32),
                            max_new_tokens=gen, arrival=0.0, priority=prio)
                for i, (gen, prio) in enumerate([(12, 0), (4, 1), (4, 1),
                                                 (4, 1)])]

    budget = _tight_budget(models, [(16, 12)])
    scfg = tsch.ServeConfig(**PREEMPT_SCFG, hw=_hw(H100_80G, budget))
    dry = tpaged.PagedScheduler(tp, tcfg, TCTX, scfg)
    steps = _steps_at(dry, trace(tsch), "_preempt")
    jdry = jpaged.PagedScheduler(
        jp, jcfg, JCtx(), jsch.ServeConfig(**PREEMPT_SCFG,
                                           hw=_hw(GPU_64G, budget)),
        key=jax.random.PRNGKey(1))
    assert steps and steps == _steps_at(jdry, trace(jsch), "_preempt")

    spec = f"oom@{steps[0]}"
    jrun, trun = _pair(models, PREEMPT_SCFG, trace, budget=budget,
                       jinj=JInjector.from_string(spec),
                       tinj=FaultInjector.from_string(spec))
    _assert_same(jrun, trun)
    ts, tm = trun
    assert tm["faults"] >= 1 and tm["preemptions"] >= 1
    assert tm["requests"] == 4 and tm["shed"] == 0
    assert ts.injector.fired == jrun[0].injector.fired
    _drained(ts)


def test_fault_mid_cow_fork_equals_the_reference(models):
    """An injected OOM at the CoW fork (a ring write cursor re-entering a
    prefix-shared page) fires before any bookkeeping mutates: the wave
    requeues its requests, the allocator stays consistent, and the tokens
    match the unfaulted run's."""
    jcfg, tcfg, _, tp = models

    def trace(mod):
        rng = np.random.default_rng(7)
        stem = rng.integers(0, jcfg.vocab_size, 32).astype(np.int32)
        return [mod.Request(rid=0, tokens=stem.copy(), max_new_tokens=4,
                            arrival=0.0),
                mod.Request(rid=1, tokens=stem.copy(), max_new_tokens=40,
                            arrival=0.0)]

    scfg_kw = dict(max_slots=4, cache_len=96, prefill_chunk=8, page_size=8,
                   prefix_cache=True)
    dry = tpaged.PagedScheduler(tp, tcfg, TCTX, tsch.ServeConfig(**scfg_kw))
    seen = []
    dry.pool.ops.fault_hook = lambda where: seen.append((dry.steps, where))
    dry.run(trace(tsch))
    unfaulted = _streams(dry)
    hits = [s for s, where in seen if where == "cow_fork"]
    assert hits, "the trace never reached a CoW fork"

    spec = f"oom@{hits[0]}"
    jrun, trun = _pair(models, scfg_kw, trace,
                       jinj=JInjector.from_string(spec),
                       tinj=FaultInjector.from_string(spec))
    _assert_same(jrun, trun)
    ts, tm = trun
    assert tm["faults"] == 1 and tm["requeues"] >= 1 and tm["requests"] == 2
    assert _streams(ts) == unfaulted
    _drained(ts)


def test_paged_chaos_run_equals_the_reference(models):
    """Two wave faults under prefix cache and preemption: every accepted
    request finishes with the unfaulted tokens, the allocator drains clean,
    and the counters are the JAX scheduler's."""
    vocab = models[0].vocab_size

    def trace(mod):
        rng = np.random.default_rng(3)
        stem = rng.integers(0, vocab, 16).astype(np.int32)
        return [mod.Request(rid=i, tokens=np.concatenate(
                    [stem, rng.integers(0, vocab, 8).astype(np.int32)]),
                    max_new_tokens=5, arrival=0.0) for i in range(5)]

    scfg_kw = dict(max_slots=3, cache_len=96, prefill_chunk=8, page_size=8,
                   prefix_cache=True, preemption=True)
    jrun, trun = _pair(models, scfg_kw, trace,
                       jinj=JInjector.from_string("oom@4,oom@9"),
                       tinj=FaultInjector.from_string("oom@4,oom@9"))
    _assert_same(jrun, trun)
    ts, tm = trun
    assert tm["faults"] == 2 and tm["requests"] == 5
    assert set(_streams(ts)) == set(range(5))
    _, tcfg, _, tp = models
    clean = tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=3, cache_len=96,
                                         prefill_chunk=8))
    clean.run(trace(tsch))
    assert _streams(ts) == _streams(clean)
    _drained(ts)


# ---------------------------------------------------------------------------
# the pool's contracts, bit for bit
# ---------------------------------------------------------------------------

def _prefilled_pool(models, cache_len, prompt, slots=2):
    """A pool holding one request's prefill of ``prompt`` tokens, with the
    dense B=1 cache it was installed from."""
    _, tcfg, _, tp = models
    toks = torch.arange(prompt).remainder(tcfg.vocab_size)[None]
    logits, cache = teng.prefill_chunked(tp, tcfg, TCTX, toks, cache_len, 8)
    pool = PagedCachePool(tp, tcfg, TCTX, slots, cache_len, 8)
    rp = pool.ops.new_request()
    pool.install(rp, cache, prompt)
    return pool, rp, logits, cache


def _equal_caches(a, b):
    la, lb = teng.leaves(a), teng.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cache_len,prompt", [(48, 20), (96, 72)],
                         ids=["linear", "ring_wrapped"])
def test_paged_decode_logits_equal_the_slot_map(models, cache_len, prompt):
    """The paged decode wave against the slot map's decode step on a 2-slot
    pool (slot 1 empty) over 12 greedy steps, across page boundaries: the
    occupied slot's logits bit for bit."""
    _, tcfg, _, tp = models
    pool, rp, logits, cache = _prefilled_pool(models, cache_len, prompt)
    slots = teng.init_serve_cache(tp, tcfg, 2, cache_len)
    tsch._copy_row(slots, cache, 0)
    step = teng.get_decode_step(tcfg, TCTX)
    tok = int(logits[0, -1].argmax())
    for i in range(12):
        toks = torch.tensor([[tok], [0]])
        want, slots = step(tp, slots, toks)
        pool.prepare_decode_write(rp, prompt + i)
        got = pool.decode_wave(tp, [rp, None],
                               np.asarray([prompt + i, 0]), toks.numpy())
        assert torch.equal(got[0], want[0]), f"step {i}"
        tok = int(want[0, -1].argmax())
    pool.release(rp)
    pool.alloc.audit()


def test_prefix_adopted_cache_equals_cold_prefill_cache(models):
    """gather_dense over trie-adopted pages reproduces the cold chunked
    prefill's cache bit for bit at the matched boundary."""
    _, tcfg, _, tp = models
    toks = np.arange(24, dtype=np.int32) % tcfg.vocab_size
    sched = tpaged.PagedScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=2, cache_len=32,
                                         prefill_chunk=8, page_size=8,
                                         prefix_cache=True))
    sched.run([tsch.Request(rid=0, tokens=toks, max_new_tokens=2)])
    matched, nodes = sched.trie.lookup(toks)
    assert matched == 24
    rp = sched.pool.ops.new_request()
    sched.trie.adopt(rp, nodes)
    got = sched.pool.gather_dense(rp.tables, nodes[-1].snapshot, matched)
    _, cold = teng.prefill_chunked(tp, tcfg, TCTX,
                                   torch.as_tensor(toks[None]).long(), 32, 8)
    _equal_caches(got, cold)
    sched.pool.release(rp)


def test_pool_spill_restore_roundtrip(models):
    """spill -> restore gives fresh private pages whose dense gather is the
    pre-spill cache bit for bit, and the spill drops every reference."""
    pool, rp, _, cache = _prefilled_pool(models, 32, 16)
    snap = pool.state_snapshot(cache)
    before = pool.gather_dense(rp.tables, snap, 16)
    _equal_caches(before, cache)
    saved = pool.spill(rp)
    for key in pool.alloc.spaces:
        assert pool.alloc.allocated(key) == 0
    rp2 = pool.restore(saved)
    _equal_caches(pool.gather_dense(rp2.tables, snap, 16), before)
    pool.release(rp2)
    pool.alloc.audit()


def test_paged_scheduler_requires_page_size(models):
    _, tcfg, _, tp = models
    with pytest.raises(ValueError, match="page_size"):
        tpaged.PagedScheduler(tp, tcfg, TCTX, tsch.ServeConfig())


# ---------------------------------------------------------------------------
# gather / scatter primitives against the reference's
# ---------------------------------------------------------------------------

def _pool(rng, pages, page, KH=2, hd=5):
    pool = rng.normal(size=(pages, page, KH, hd)).astype(np.float32)
    pool[ZERO_PAGE] = 0.0
    return pool


@pytest.mark.parametrize("table", [[5, 3, 7], [5, ZERO_PAGE, 7],
                                   [[2, 3, 4], [6, ZERO_PAGE, ZERO_PAGE]]],
                         ids=["1d", "1d_hole", "batched"])
def test_gather_paged_tokens_equals_the_reference(table):
    page, Sc = 4, 10                          # a trailing partial page
    pool = _pool(np.random.default_rng(0), 8, page)
    want = np.asarray(jblocks.gather_paged_tokens(
        jnp.asarray(pool), jnp.asarray(table, jnp.int32), 0, Sc))
    got = tblocks.gather_paged_tokens(torch.from_numpy(pool),
                                      torch.tensor(table), 0, Sc)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("table", [[5, SCRATCH_PAGE, 7], [[2, 3, 4], [6, 7, 5]]],
                         ids=["1d", "batched"])
def test_scatter_paged_tokens_equals_the_reference(table):
    """Scatter writes each block's rows to its page in place; the padded tail
    of the last page and scratch-page blocks never touch other pages; the
    scratch page's contents are not compared (its writes have no order)."""
    page, Sc = 4, 10
    rng = np.random.default_rng(1)
    pool = _pool(rng, 8, page)
    lead = np.asarray(table).shape[:-1]
    dense = rng.normal(size=lead + (Sc, 2, 5)).astype(np.float32)
    want = np.asarray(jblocks.scatter_paged_tokens(
        jnp.asarray(pool), jnp.asarray(table, jnp.int32), jnp.asarray(dense),
        0, page))
    tpool = torch.from_numpy(pool.copy())
    out = tblocks.scatter_paged_tokens(tpool, torch.tensor(table),
                                       torch.from_numpy(dense), 0, page)
    assert out is tpool
    keep = [p for p in range(8) if p != SCRATCH_PAGE]
    assert np.array_equal(out.numpy()[keep], want[keep])
    back = tblocks.gather_paged_tokens(out, torch.tensor(table), 0, Sc)
    if SCRATCH_PAGE not in np.asarray(table):
        assert np.array_equal(back.numpy(), dense)


# ---------------------------------------------------------------------------
# serving fault injection on the slot map, and the launcher
# ---------------------------------------------------------------------------

def test_slot_map_wave_fault_equals_the_reference(models):
    """The slot map's decode wave fires the injector at ``decode_wave`` and a
    stall at the step's start, as the reference's does: a faulted wave
    requeues its requests, and streams and counters equal the JAX
    scheduler's and the unfaulted run's."""
    jcfg, tcfg, jp, tp = models
    shapes = [(16, 5)] * 4
    spec = "oom@3,stall@1x0.01"
    js = jsch.ContinuousBatchingScheduler(
        jp, jcfg, JCtx(), jsch.ServeConfig(max_slots=2, cache_len=32,
                                           prefill_chunk=8),
        injector=JInjector.from_string(spec))
    ts = tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=2, cache_len=32,
                                         prefill_chunk=8),
        injector=FaultInjector.from_string(spec))
    jm = js.run(_trace(jsch, jcfg.vocab_size, shapes))
    tm = ts.run(_trace(tsch, tcfg.vocab_size, shapes))
    assert _streams(ts) == _streams(js)
    assert ts.admission_order == js.admission_order
    for key in ("decode_waves", "prefill_chunks", "faults", "requeues"):
        assert tm[key] == jm[key], key
    assert tm["faults"] == 1 and tm["requeues"] >= 1
    assert ts.injector.fired == js.injector.fired == [("stall", 1), ("oom", 3)]
    assert _streams(ts) == _slot_map_streams(models, shapes, 32, slots=2)


def test_launcher_serves_paged_with_faults(capsys):
    """The CPU drive of the paged entry point with prefix cache, preemption
    and an injected wave fault: every request finishes, and the summary
    prints the paging and resilience lines."""
    from repro_torch.launch import serve
    argv = ["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
            "--arrival-rate", "0", "--page-size", "8", "--prefix-cache",
            "--preemption", "--inject", "oom@5"]
    sched, m = serve.main(argv)
    out = capsys.readouterr().out
    assert isinstance(sched, tpaged.PagedScheduler)
    assert m["requests"] == 8 and m["faults"] == 1
    assert "paged(page=8, prefix=True, preempt=True)" in out
    assert "paging: page high-watermark" in out and "prefix hit rate" in out
    assert "1 faulted waves" in out
    _drained(sched)
    with pytest.raises(SystemExit, match="require --page-size"):
        serve.setup(serve.parse_args(argv[:7] + ["--prefix-cache"]))
