"""Serving of state-carrying models in the port against the JAX package:
``jamba-1.5-large-398b.reduced()`` (a mamba/MoE layer and an attention/
dense layer) and ``mamba2-130m.reduced()`` (two mamba layers), in fp32.

Weights come from the JAX init through ``bridge.params_from_jax``; prompts
from seeded numpy generators.  The cases are the reference's for these
configs (``tests/test_serving.py``, ``test_paging.py``,
``test_residency.py``) and the port's own contracts for what it does in
place: a demand re-run puts back the mamba states the discarded run
advanced, a masked wave keeps non-members' state bit for bit, and the paged
pools carry one state block per request.

Tolerances: logits and caches against JAX rtol = atol = 1e-4 (the port's
``TOL``); the port's chunked prefill against its single pass 2e-4 (the
reference's own tolerance for it).  Token streams, scheduler counters,
modeled bytes, and every logits row the port compares with itself are
exact."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import GPU_64G, registry  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import paged_cache as jpc  # noqa: E402
from repro.serving import paged_scheduler as jpaged  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro_torch.bridge import cache_from_jax, layers_in_order, params_from_jax  # noqa: E402
from repro_torch.configs import H100_80G, get_config  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving import paged_scheduler as tpaged  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
JCTX = JCtx()
JAMBA, MAMBA = "jamba-1.5-large-398b", "mamba2-130m"
ARCHS = (JAMBA, MAMBA)
torch.set_num_threads(min(torch.get_num_threads(), 2))

_MODELS: dict = {}
# jitted: op by op, the reference's SSD dispatches hundreds of small ops
_j_forward = jax.jit(jtf.forward, static_argnums=(1, 2),
                     static_argnames=("return_cache", "cache_len"))
_j_extend = jax.jit(jtf.extend_step, static_argnums=(1, 2))
_j_decode = jax.jit(jtf.decode_step, static_argnums=(1, 2))


def _models(arch):
    """(jax cfg, port cfg, jax params, port params), made once per arch."""
    if arch not in _MODELS:
        jcfg = registry()[arch].reduced()
        tcfg = get_config(arch).reduced()
        jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        _MODELS[arch] = (jcfg, tcfg, jp,
                         params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU))
    return _MODELS[arch]


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _keyed(tree, path=()):
    """(path, tensor) of every leaf, dict keys sorted: the JAX tree's order
    (its dicts come back key-sorted) and the port's compare leaf by leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _keyed(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _keyed(v, path + (i,))]
    return [(path, tree)]


def _assert_cache_close(t_cache, j_cache, cfg, B, **tol):
    want = cache_from_jax(jax.tree.map(np.asarray, j_cache), cfg, B, CPU)
    got_l, want_l = _keyed(t_cache), _keyed(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (p, a), (_, b) in zip(got_l, want_l):
        assert a.shape == b.shape, p
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(p),
                                   **(tol or TOL))


# ---------------------------------------------------------------------------
# configs, weights and the memory model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_init_shapes(arch):
    """``params_from_jax`` carries every leaf of the JAX tree unchanged (its
    scanned periods unstacked in layer order, mamba mixers included), and
    the port's own init has the same tree, shapes and types."""
    jcfg, tcfg, jp, tp = _models(arch)
    jnp_tree = jax.tree.map(np.asarray, jp)
    top = {k: v for k, v in jnp_tree.items() if k not in ("pre", "periods", "rem")}
    want = _keyed(top) + [(("layers", i) + p, a) for i, layer in
                          enumerate(layers_in_order(jnp_tree, jcfg))
                          for p, a in _keyed(layer)]
    got = _keyed(tp)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(p))
    mixer = {p[3] for p, _ in got if p[0] == "layers" and p[2] == "mixer"}
    assert "A_log" in mixer and ("wq" in mixer) == (arch == JAMBA)
    mine = ttf.init_params(tcfg, device=CPU, seed=3)
    sig = lambda t: [(p, tuple(a.shape), str(a.dtype).split(".")[-1])  # noqa: E731
                     for p, a in _keyed(t)]
    assert sig(mine) == sig(tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_equals_the_reference(arch):
    """The mamba terms of the memory model, the reference's formulas
    (their B/C over-count included)."""
    jcfg, tcfg, _, _ = _models(arch)
    for j, t in ((registry()[arch], get_config(arch)), (jcfg, tcfg)):
        assert tmm.decode_cache_bytes(t, 4096) == jmm.decode_cache_bytes(j, 4096)
        assert tmm.total_params(t) == jmm.total_params(j)
        kw = dict(requests=3, cache_len=256, decode_tokens=4, prefill_tokens=16)
        assert tmm.serving_peak_bytes(t, **kw) == jmm.serving_peak_bytes(j, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_block_bytes_equal_the_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    jl = jpc.CacheLayout(jp, jcfg, 48)
    tl = tpc.CacheLayout(tcfg, 48)
    assert tl.state_bytes(2) == jl.state_bytes(2) > 0
    for jg, tg in zip(jl.groups, tl.groups):
        assert tl.page_bytes(tg, 8, 2) == jl.page_bytes(jg, 8, 2)
    assert [(g.length, g.ring) for g in tl.groups] == \
        [(g.length, g.ring) for g in jl.groups]


# ---------------------------------------------------------------------------
# prefill, extension, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(2, 24, jcfg.vocab_size)
    jl, jst, jc = _j_forward(jp, jcfg, JCTX, {"tokens": jnp.asarray(toks)},
                             return_cache=True, cache_len=32)
    with torch.no_grad():
        tl, tst, tc = ttf.forward(tp, tcfg, TCTX,
                                  {"tokens": torch.from_numpy(toks).long()},
                                  return_cache=True, cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if tcfg.moe is not None:
        assert tst["load_per_layer"].tolist() == \
            np.asarray(jst["load_per_layer"]).tolist()
    _assert_cache_close(tc, jc, tcfg, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_extend_and_decode_steps_match_jax(arch):
    """Prefill 16 tokens, extend by a 5-token chunk (shorter than the SSD
    chunk, so the scan runs at chunk 5), then decode 3 tokens."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(2, 24, jcfg.vocab_size, seed=2)
    S, C = 16, 5
    _, _, jc = _j_forward(jp, jcfg, JCTX, {"tokens": jnp.asarray(toks[:, :S])},
                          return_cache=True, cache_len=32)
    with torch.no_grad():
        _, _, tc = ttf.forward(tp, tcfg, TCTX,
                               {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               return_cache=True, cache_len=32)
        jl, jc = _j_extend(jp, jcfg, JCTX, jc, jnp.asarray(toks[:, S:S + C]))
        tl, tc = ttf.extend_step(tp, tcfg, TCTX, tc,
                                 torch.from_numpy(toks[:, S:S + C]).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(tc, jc, tcfg, 2)
        for i in range(S + C, S + C + 3):
            jl, jc = _j_decode(jp, jcfg, JCTX, jc, jnp.asarray(toks[:, i:i + 1]))
            tl, tc = ttf.decode_step(tp, tcfg, TCTX, tc,
                                     torch.from_numpy(toks[:, i:i + 1]).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(tc, jc, tcfg, 2)


def _cast_like(tree, like):
    if isinstance(tree, dict):
        return {k: _cast_like(tree[k], like[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_like(a, b) for a, b in zip(tree, like))
    return tree.to(like.dtype)


def test_bf16_weights_keep_the_fp32_mamba_state_over_32_decode_steps():
    """mamba2 with bf16 weights over the fp32 cache that serving holds:
    prefill 16 tokens, then 32 decode steps on the same tokens as the JAX
    model.  The first layer's input is the same bf16 embedding in both, so
    its state is held every step at 1e-3 (the two frameworks' bf16
    projections differ by an ulp; rounding the state to bf16 each step puts
    it ~5e-3 off).  The port casts each mixer's output back to bf16, where
    the reference lets the residual stream promote to fp32, so the logits
    are held at 3e-2, bf16's resolution over the model."""
    jcfg, tcfg = registry()[MAMBA].reduced(), get_config(MAMBA).reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    tp = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                         tcfg, CPU)
    tp = _cast_like(tp, ttf.init_params(tcfg, device=CPU, dtype=torch.bfloat16))
    toks = _tokens(2, 48, jcfg.vocab_size, seed=4)
    S = 16
    _, _, jc = _j_forward(jp, jcfg, JCTX, {"tokens": jnp.asarray(toks[:, :S])},
                          return_cache=True, cache_len=64)
    with torch.no_grad():
        _, _, tc = ttf.forward(tp, tcfg, TCTX,
                               {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               return_cache=True, cache_len=64)
        for i in range(S, S + 32):
            jl, jc = _j_decode(jp, jcfg, JCTX, jc, jnp.asarray(toks[:, i:i + 1]))
            tl, tc = ttf.decode_step(tp, tcfg, TCTX, tc,
                                     torch.from_numpy(toks[:, i:i + 1]).long())
            want = cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, 2, CPU)
            got = tc["layers"][0]["ssm"]["ssm"]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), want["layers"][0]["ssm"]["ssm"].numpy(),
                rtol=1e-3, atol=1e-3, err_msg=f"step {i}")
            np.testing.assert_allclose(tl.float().numpy(),
                                       np.asarray(jl, np.float32),
                                       rtol=3e-2, atol=3e-2, err_msg=f"step {i}")


def test_chunked_prefill_matches_single_pass():
    """The reference's case (jamba, S 48, chunk 16): the chunked prefill's
    logits and cache equal the single pass's, and decode continues alike."""
    _, tcfg, _, tp = _models(JAMBA)
    toks = torch.from_numpy(_tokens(2, 48, tcfg.vocab_size)).long()
    lf, cf = teng.prefill(tp, tcfg, TCTX, {"tokens": toks}, 56)
    lc, cc = teng.prefill_chunked(tp, tcfg, TCTX, toks, 56, 16)
    np.testing.assert_allclose(lf.numpy(), lc.numpy(), atol=2e-4)
    for (p, a), (_, b) in zip(_keyed(cf), _keyed(cc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, err_msg=str(p))
    nxt = torch.full((2, 1), 7, dtype=torch.long)
    with torch.no_grad():
        l1, _ = ttf.decode_step(tp, tcfg, TCTX, cf, nxt)
        l2, _ = ttf.decode_step(tp, tcfg, TCTX, cc, nxt)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=2e-4)


def test_generate_mamba2_matches_jax():
    """Greedy generation against the JAX engine's; a sampled one repeats
    itself from the default seed (the reference's regression case)."""
    jcfg, tcfg, jp, tp = _models(MAMBA)
    toks = _tokens(2, 8, jcfg.vocab_size)
    want = jeng.generate(jp, jcfg, JCTX, {"tokens": jnp.asarray(toks)}, steps=4,
                         cache_len=16)
    batch = {"tokens": torch.from_numpy(toks).long()}
    got = teng.generate(tp, tcfg, TCTX, batch, steps=4, cache_len=16)
    assert got.tolist() == np.asarray(want).tolist()
    a = teng.generate(tp, tcfg, TCTX, batch, steps=4, cache_len=16, temperature=0.8)
    b = teng.generate(tp, tcfg, TCTX, batch, steps=4, cache_len=16, temperature=0.8)
    assert a.shape == (2, 4) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the slot map, masked waves and the residency tier
# ---------------------------------------------------------------------------

def _trace(mod, vocab, shapes, seed=0, stem=None):
    rng = np.random.default_rng(seed)
    out = []
    for i, sh in enumerate(shapes):
        S, g, prio = (tuple(sh) + (0,))[:3]
        toks = rng.integers(0, vocab, S).astype(np.int32)
        if stem is not None:
            toks = np.concatenate([stem, toks])
        out.append(mod.Request(rid=i, tokens=toks, max_new_tokens=g, arrival=0.0,
                               priority=prio))
    return out


def _drive(sched, reqs):
    for r in reqs:
        sched.submit(r)
    n = 0
    while sched.queue or sched.active or sched._prefilling is not None:
        sched.step(float(n))
        n += 1
        assert n < 1000, "scheduler failed to drain"
    return {r.rid: list(r.out) for r in sched.finished}


def _recording(store: dict):
    def hook(sched):
        append = sched._append_token

        def rec(req, logits_v, now):
            store[(req.rid, len(req.out))] = np.array(logits_v)
            return append(req, logits_v, now)
        sched._append_token = rec
    return hook


SHAPES = [(20, 6), (9, 5), (33, 4), (16, 5), (12, 6)]
COUNTERS = ("decode_waves", "prefill_chunks", "max_occupancy", "expert_waves",
            "mean_distinct_experts", "mean_wave_occupancy", "forced_includes",
            "prefetch_hits", "prefetch_misses", "demand_reruns",
            "modeled_peak_bytes", "requeues", "faults", "preemptions",
            "page_hwm_bytes", "prefix_hits", "prefix_tokens_reused")


def _run(arch, kw, *, jax_side=False, hook=None, shapes=SHAPES, stem=None,
         hw=None, eager=False):
    """The port's scheduler (or the JAX one) on a trace; closed at the end.
    Returns (streams, metrics, scheduler)."""
    jcfg, tcfg, jp, tp = _models(arch)
    mod = jsch if jax_side else tsch
    scfg = {"max_slots": 3, "cache_len": 48, "prefill_chunk": 8, **kw}
    if hw is not None:
        scfg["hw"] = hw[jax_side]
    paged = scfg.get("page_size", 0) > 0
    if jax_side:
        cls = jpaged.PagedScheduler if paged else jsch.ContinuousBatchingScheduler
        sched = cls(jp, jcfg, JCTX, jsch.ServeConfig(**scfg),
                    key=jax.random.PRNGKey(1))
    else:
        cls = tpaged.PagedScheduler if paged else tsch.ContinuousBatchingScheduler
        sched = cls(tp, tcfg, TCTX, tsch.ServeConfig(**scfg), eager=eager)
    try:
        if hook is not None:
            hook(sched)
        out = _drive(sched, _trace(mod, tcfg.vocab_size, shapes, stem=stem))
        return out, sched.metrics(1.0), sched
    finally:
        if hasattr(sched, "close"):
            sched.close()


def _same(port, ref):
    (to, tm, ts), (jo, jm, js) = port, ref
    assert to == jo
    assert ts.admission_order == js.admission_order
    for key in COUNTERS:
        if key in jm:
            assert tm[key] == jm[key], key
    assert tm.get("residency") == jm.get("residency")
    assert tm["nonfinite_logits"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_map_streams_match_jax(arch):
    """Both scheduler modes of the port (its eager function and its compiled
    step, which on the CPU runs that function) against the JAX scheduler."""
    ref = _run(arch, {}, jax_side=True)
    _same(_run(arch, {}), ref)
    assert _run(arch, {}, eager=True)[0] == ref[0]


def _no_prefetch(decode_reruns: list, chunk_reruns: list):
    """A hook that switches the residency prefetch off, so decode waves miss
    and re-run, and counts the re-runs of decode waves and prefill chunks."""
    def hook(sched):
        sched.residency.prefetch = lambda params, predicted: None
        for name, store in (("_decode_wave_expert", decode_reruns),
                            ("_prefill_step", chunk_reruns)):
            fn = getattr(sched, name)

            def counted(now, fn=fn, store=store):
                before = sched.demand_reruns
                fn(now)
                store.append(sched.demand_reruns - before)
            setattr(sched, name, counted)
    return hook


@pytest.mark.parametrize("paged", [False, True])
def test_waves_and_residency_reruns_equal_the_default_run(paged):
    """Jamba with waves of 2 and 1 resident expert per MoE layer, the
    prefetch off: decode waves and prefill chunks (extends included) re-run
    after demand restores, each from the mamba states the discarded run
    advanced put back.  Every sampled logits row equals the all-resident
    run's bit for bit, and the run is the JAX scheduler's with the same
    prefetch off."""
    base_kw = {"page_size": 8} if paged else {}
    kw = dict(base_kw, wave_size=2, resident_experts=1)
    decode_reruns, chunk_reruns = [], []
    rows, base = {}, {}
    rec = _recording(rows)
    port = _run(JAMBA, kw, hook=lambda s: (_no_prefetch(decode_reruns,
                                                        chunk_reruns)(s), rec(s)))
    assert sum(decode_reruns) > 0, "no decode wave re-ran"
    assert sum(chunk_reruns) > 0, "no prefill chunk re-ran"
    default = _run(JAMBA, base_kw, hook=_recording(base))
    assert port[0] == default[0]
    assert rows.keys() == base.keys()
    assert all(np.array_equal(rows[k], base[k]) for k in base)

    def jax_no_prefetch(sched):
        sched.residency.prefetch = lambda params, predicted: params
    _same(port, _run(JAMBA, kw, jax_side=True, hook=jax_no_prefetch))


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_wave_keeps_non_members_state_bitwise(arch):
    """The masked step over rows with live state: non-members keep every
    cache leaf and their position bit for bit, members get the unmasked
    step's cache rows and logits."""
    _, tcfg, _, tp = _models(arch)
    toks = torch.from_numpy(_tokens(4, 12, tcfg.vocab_size)).long()
    _, cache = teng.prefill(tp, tcfg, TCTX, {"tokens": toks}, 24)
    twin = teng._fill(cache, iter([t.clone() for t in teng.leaves(cache)]))
    before = [t.clone() for t in teng.leaves(cache)]
    mask = torch.tensor([True, False, True, False])
    nxt = torch.tensor([[3], [4], [5], [6]])
    lm, cache, _ = teng.get_decode_step_masked(tcfg, TCTX)(tp, cache, nxt, mask)
    lf, twin = teng.get_decode_step(tcfg, TCTX)(tp, twin, nxt)
    for a, b, f in zip(teng.leaves(cache), before, teng.leaves(twin)):
        assert torch.equal(a[~mask], b[~mask])
        assert torch.equal(a[mask], f[mask])
    assert torch.equal(lm[mask], lf[mask])


# ---------------------------------------------------------------------------
# pages: state blocks beside K/V pages
# ---------------------------------------------------------------------------

MATRIX = {MAMBA: [(16, 6), (24, 4)], JAMBA: [(16, 5), (24, 4)]}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_matrix_row_matches_jax_and_the_slot_map(arch):
    """The reference's matrix rows (cache_len 48, pages of 8, chunk 8, 3
    slots): the port's paged run equals the JAX paged run (streams, counts,
    page high-water mark) and the port's slot map; the allocator drains."""
    kw = dict(page_size=8)
    port = _run(arch, kw, shapes=MATRIX[arch])
    _same(port, _run(arch, kw, jax_side=True, shapes=MATRIX[arch]))
    assert port[0] == _run(arch, {}, shapes=MATRIX[arch])[0]
    assert port[1]["page_hwm_bytes"] > 0
    pool = port[2].pool
    pool.alloc.audit()
    assert all(pool.alloc.allocated(k) == 0 for k in pool.alloc.spaces)


def _tight_hw(arch, shapes):
    """The reference's budget of about 2.2 worst-case requests, as each
    package's hardware profile."""
    jcfg, tcfg, jp, _ = _models(arch)
    pool = jpc.PagedCachePool(jp, jcfg, JCTX, 4, 48, 8)
    per_req = max(pool.ops.worst_case_bytes(S + g) for S, g, *_ in shapes)
    base = jmm.serving_paged_peak_bytes(jcfg, page_bytes=0, decode_tokens=4,
                                        prefill_tokens=8)
    budget = base + 2.2 * per_req
    return {True: dataclasses.replace(GPU_64G, hbm_bytes=budget, alpha=1.0),
            False: dataclasses.replace(H100_80G, hbm_bytes=budget, alpha=1.0)}


def test_prefix_hits_and_preemption_match_jax():
    """Jamba: 4 requests sharing a 16-token stem resume from the trie's
    pages and state snapshots; then, under a budget of about two requests,
    the low-priority one is spilled (its state block with its pages) and
    restored.  Both runs equal the JAX scheduler's and the slot map's."""
    jcfg = _models(JAMBA)[0]
    stem = np.random.default_rng(100).integers(0, jcfg.vocab_size, 16).astype(np.int32)
    kw = dict(max_slots=4, page_size=8, prefix_cache=True)
    shapes = [(8, 5)] * 4
    port = _run(JAMBA, kw, shapes=shapes, stem=stem)
    _same(port, _run(JAMBA, kw, jax_side=True, shapes=shapes, stem=stem))
    assert port[1]["prefix_hits"] >= 3 and port[1]["prefix_tokens_reused"] > 0
    assert port[0] == _run(JAMBA, {"max_slots": 4}, shapes=shapes, stem=stem)[0]

    shapes = [(16, 12, 0), (16, 4, 1), (16, 4, 1), (16, 4, 1)]
    kw = dict(max_slots=4, page_size=8, preemption=True)
    hw = _tight_hw(JAMBA, shapes)
    port = _run(JAMBA, kw, shapes=shapes, hw=hw)
    _same(port, _run(JAMBA, kw, jax_side=True, shapes=shapes, hw=hw))
    assert port[1]["preemptions"] >= 1
    assert port[0] == _run(JAMBA, {"max_slots": 4}, shapes=shapes)[0]


def test_pool_spill_restore_round_trip_and_prefix_resume():
    """Pool level, bit for bit: a spill and restore give back the dense
    cache (state block included) on fresh pages, and a prefix-trie resume
    (adopted pages + the node's state snapshot) equals the cold chunked
    prefill's cache at the matched boundary."""
    _, tcfg, _, tp = _models(JAMBA)
    toks = torch.arange(16)[None] % tcfg.vocab_size
    _, cache = teng.prefill_chunked(tp, tcfg, TCTX, toks, 32, 8)
    pool = tpc.PagedCachePool(tp, tcfg, TCTX, 2, 32, 8)
    rp = pool.ops.new_request()
    pool.install(rp, cache, 16)
    snap = pool.state_snapshot(cache)
    before = pool.gather_dense(rp.tables, snap, 16)
    for (p, a), (_, b) in zip(_keyed(before), _keyed(cache)):
        assert torch.equal(a, b), p
    saved = pool.spill(rp)
    assert all(pool.alloc.allocated(k) == 0 for k in pool.alloc.spaces)
    rp2 = pool.restore(saved)
    sid = rp2.state_block
    for st, live in zip(pool._state_pools(), [layer["ssm"] for layer in cache["layers"]
                                               if "ssm" in layer]):
        for n in ("ssm", "conv"):
            assert torch.equal(st[n][sid], live[n][0])
    after = pool.gather_dense(rp2.tables, snap, 16)
    for (p, a), (_, b) in zip(_keyed(before), _keyed(after)):
        assert torch.equal(a, b), p
    pool.release(rp2)
    pool.alloc.audit()

    sched = tpaged.PagedScheduler(tp, tcfg, TCTX, tsch.ServeConfig(
        max_slots=2, cache_len=32, prefill_chunk=8, page_size=8, prefix_cache=True))
    sched.run([tsch.Request(rid=0, tokens=np.arange(24, dtype=np.int32),
                            max_new_tokens=2)])
    matched, nodes = sched.trie.lookup(np.arange(24, dtype=np.int32))
    assert matched == 24
    rp = sched.pool.ops.new_request()
    sched.trie.adopt(rp, nodes)
    got = sched.pool.gather_dense(rp.tables, nodes[-1].snapshot, matched)
    _, cold = teng.prefill_chunked(tp, tcfg, TCTX,
                                   torch.arange(24)[None], 32, 8)
    for (p, a), (_, b) in zip(_keyed(got), _keyed(cold)):
        assert torch.equal(a, b), p
    sched.pool.release(rp)
