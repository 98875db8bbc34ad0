"""The reference hooks the port carries for benchmarks and planners, against
the JAX package where it has them:

* ``ContinuousBatchingScheduler.reset`` and ``PagedScheduler.reset``: a run,
  a reset and the same trace again on both packages' schedulers, from the
  same weights, give the JAX scheduler's streams, admission and counters,
  and the port keeps its compiled steps; a paged reset frees every page as
  the JAX one does; ``ExpertResidency.reset_stats`` zeroes the transfer
  counters as the JAX tier's does;
* ``Trainer(par=..., static_override=...)`` and ``choose_chunks``: the JAX
  trainer's choices and chunk trace, ``benchmarks/fig5_mact.py``'s setting
  included;
* ``memory_model.active_params`` and ``ModelConfig.remainder_layers`` for
  every config of the registry;
* ``dispatch.make_plan`` and ``scatter_values``, integer for integer;
* ``remat_policy="selective"``: the loss and every gradient against
  ``jax.grad`` of the JAX package's selective layer (1e-4), and in a forward
  and backward the q, k and v projections computed once (twice under
  "full", whose backward recomputes the layer) while the rest of the layer,
  the output projection, runs twice (once under "none")."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.configs.base import HardwareProfile as JHardwareProfile  # noqa: E402
from repro.core import dispatch as jdsp  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import paged_scheduler as jpaged  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro.training import step as jstep  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, registry  # noqa: E402
from repro_torch.configs.base import HardwareProfile  # noqa: E402
from repro_torch.core import dispatch as tdsp  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.optim.adamw import named_params  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import paged_scheduler as tpaged  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402
from repro_torch.training.step import loss_fn, make_train_state  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
torch.set_num_threads(min(torch.get_num_threads(), 2))


# ---------------------------------------------------------------------------
# scheduler reset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """One reduced Mixtral's weights in both packages (``params_from_jax``)."""
    jc, tc = jregistry()["mixtral-8x7b"].reduced(), get_config("mixtral-8x7b").reduced()
    jp = jtf.init_params(jax.random.PRNGKey(3), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, CPU)


def _trace(mod, n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, tokens=rng.integers(1, 100, size=int(rng.integers(5, 20))),
                        max_new_tokens=int(rng.integers(3, 9))) for i in range(n)]


COUNTERS = ("requests", "generated_tokens", "decode_waves", "prefill_chunks",
            "max_occupancy", "modeled_peak_bytes", "nonfinite_logits", "shed", "requeues",
            "faults", "expert_waves", "mean_distinct_experts", "mean_wave_occupancy",
            "forced_includes", "prefetch_hits", "prefetch_misses", "demand_reruns",
            "residency", "preemptions", "prefix_evictions", "page_allocated_bytes")


def _run(sched, mod):
    m = sched.run(_trace(mod))
    streams = [list(r.out) for r in sorted(sched.finished, key=lambda r: r.rid)]
    return streams, {k: m[k] for k in COUNTERS if k in m}, list(sched.admission_order)


def _same(port, ref):
    """The port's run equals the JAX scheduler's: streams, admission order and
    every counter both report, the residency tier's transfers included."""
    assert port[0] == ref[0] and port[2] == ref[2]
    shared = sorted(set(port[1]) & set(ref[1]))
    assert {k: port[1][k] for k in shared} == {k: ref[1][k] for k in shared}
    assert ("residency" in port[1]) == ("residency" in ref[1])


SCHEDULERS = {
    "slot map": (False, {}),
    "expert-aware": (False, dict(wave_size=2, resident_experts=2, probe_router=True)),
    "paged": (True, dict(page_size=8, prefix_cache=True, preemption=True)),
}


def _pair(served, paged, kw):
    jc, tc, jp, tp = served
    scfg = dict(max_slots=2, cache_len=40, prefill_chunk=8, **kw)
    jcls = jpaged.PagedScheduler if paged else jsch.ContinuousBatchingScheduler
    tcls = tpaged.PagedScheduler if paged else tsch.ContinuousBatchingScheduler
    return (jcls(jp, jc, JCtx(), jsch.ServeConfig(**scfg)),
            tcls(tp, tc, DistContext(device=CPU), tsch.ServeConfig(**scfg)))


@pytest.mark.parametrize("mode", sorted(SCHEDULERS))
def test_reset_then_rerun_equals_the_jax_scheduler(served, mode):
    """Run, ``reset()`` and the same trace again on the JAX scheduler and on
    the port's, from the same weights: both runs equal the JAX scheduler's,
    the second one (its warm residency tier's transfers included) after the
    reset; the port keeps its compiled steps and caches; and the re-run's
    streams and admission equal a fresh port scheduler's."""
    paged, kw = SCHEDULERS[mode]
    jsched, sched = _pair(served, paged, kw)
    try:
        _same(_run(sched, tsch), _run(jsched, jsch))
        steps = (sched._decode, sched._extend, sched._prefill)
        pool, pcache = sched.cache, sched._pcache
        entries = teng.step_cache_info()["entries"]
        jsched.reset()
        sched.reset()
        assert not sched.queue and not sched.active and not sched.finished
        assert sched.free_slots == list(range(sched.scfg.max_slots))
        assert sched.steps == sched.decode_waves == sched.prefill_chunks == 0
        assert sched.demand_reruns == sched.prefetch_hits == sched.expert_waves == 0
        if sched.residency is not None:
            assert sched.residency.stats() == jsched.residency.stats()
            assert sched.residency.stats()["restores"] == 0
            assert [set(s) for s in sched.residency.resident] == \
                [set(s) for s in jsched.residency.resident]
        if sched.telemetry is not None:
            assert all(sched.telemetry.loads(r.rid) is None for r in _trace(tsch))
        got = _run(sched, tsch)
        _same(got, _run(jsched, jsch))
        # the compiled steps and the caches they own are the ones it had
        assert (sched._decode, sched._extend, sched._prefill) == steps
        assert sched.cache is pool and sched._pcache is pcache
        assert teng.step_cache_info()["entries"] == entries
    finally:
        sched.close()
    _, tc, _, tp = served
    fresh = (tpaged.PagedScheduler if paged else tsch.ContinuousBatchingScheduler)(
        tp, tc, DistContext(device=CPU),
        tsch.ServeConfig(max_slots=2, cache_len=40, prefill_chunk=8, **kw))
    try:
        want = _run(fresh, tsch)
    finally:
        fresh.close()
    assert got[0] == want[0] and got[2] == want[2]


def _free(alloc):
    return sorted((str(k), alloc.free_pages(k), alloc.allocated(k)) for k in alloc.spaces)


def test_paged_reset_frees_every_page(served):
    """Stopped mid-trace, with requests holding pages, both packages' paged
    schedulers reset to every page free and an empty trie."""
    jsched, sched = _pair(served, True, dict(page_size=8, prefix_cache=True))
    alloc, jalloc = sched.pool.alloc, jsched.pool.alloc
    free = _free(alloc)
    assert free == _free(jalloc)
    for s, mod in ((sched, tsch), (jsched, jsch)):
        for r in _trace(mod):
            s.submit(r)
        for _ in range(6):                     # stop mid-trace: requests hold pages
            s.step()
    assert sched.active or sched._prefilling is not None
    assert _free(alloc) == _free(jalloc) != free
    assert sched.trie.n_nodes == jsched.trie.n_nodes
    jsched.reset()
    sched.reset()
    assert _free(alloc) == _free(jalloc) == free
    assert alloc.allocated_bytes() == jalloc.allocated_bytes() == 0
    alloc.audit()
    assert sched.trie.n_nodes == jsched.trie.n_nodes == 0
    assert not sched._snapshots and not sched._shared_len
    assert sched.preemptions == sched.prefix_evictions == 0


def test_reset_stats_zeroes_the_residency_counters(served):
    """``ExpertResidency.reset_stats`` after a run: the JAX tier's counters,
    zeroed, with the resident sets and high-watermark kept as its are."""
    jsched, sched = _pair(served, False, dict(wave_size=2, resident_experts=2))
    try:
        _same(_run(sched, tsch), _run(jsched, jsch))
        res, jres = sched.residency, jsched.residency
        assert res.restores and res.offloads
        resident = [set(s) for s in res.resident]
        jres.reset_stats()
        res.reset_stats()
        assert res.stats() == jres.stats() == {
            "restores": 0, "offloads": 0, "demand_restores": 0,
            "resident_experts_hwm": max(len(s) for s in resident)}
        assert [set(s) for s in res.resident] == resident == \
            [set(s) for s in jres.resident]                  # the sets stay
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# trainer overrides
# ---------------------------------------------------------------------------

TIGHT = dict(name="tight", hbm_bytes=9e6, peak_flops=1, hbm_bw=1, ici_bw=1, alpha=0.9)


def test_fig5_static_override_matches_the_jax_trainer():
    """``benchmarks/fig5_mact.py``'s trainer: the smoke DeepSeek-mini against
    a tight memory profile, ``static_override=0.0``, every expert one peer of
    the planning view: the same choices and chunk trace."""
    jc, tc = jregistry()["deepseek-mini-8l"].reduced(), get_config("deepseek-mini-8l").reduced()
    kw = dict(seq_len=128, global_batch=4, lr=1e-3, use_mact=True, static_override=0.0,
              mact_ep_view=tc.moe.num_experts)
    jt = jtrainer.Trainer(jc, JCtx(), hw=JHardwareProfile(**TIGHT), **kw)
    tt = Trainer(tc, DistContext(device=CPU), hw=HardwareProfile(**TIGHT), **kw)
    assert tt.mact.static == jt.mact.static == 0.0
    assert tt.choose_chunks() == jt.choose_chunks()
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    jt.fit(3, jstate)
    tt.fit(3, tstate)
    assert tt.chunk_trace == jt.chunk_trace
    assert tt.choose_chunks() == jt.choose_chunks()


@pytest.mark.parametrize("e,b,static", [(1, 4, None), (4, 2, None), (8, 1, 43e9),
                                        (2, 4, 0.0), (4, 8, 60e9)])
def test_par_and_static_override_plan_as_the_jax_trainer(e, b, static):
    """At Mixtral-8x7B's full width on the H100 profile: a given
    ``Parallelism`` and static-bytes override give the JAX trainer's
    cold-start schedule and MACT's numbers."""
    from repro_torch.configs import H100_80G
    hw = dict(name=H100_80G.name, hbm_bytes=H100_80G.hbm_bytes,
              peak_flops=H100_80G.peak_flops, hbm_bw=H100_80G.hbm_bw,
              ici_bw=H100_80G.ici_bw, alpha=H100_80G.alpha)
    jc = dataclasses.replace(jregistry()["mixtral-8x7b"], num_layers=4)
    tc = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=4)
    kw = dict(seq_len=2048, global_batch=8, static_override=static)
    jt = jtrainer.Trainer(jc, JCtx(), hw=JHardwareProfile(**hw),
                          par=jmm.Parallelism(e=e, b=b), **kw)
    tt = Trainer(tc, DistContext(device=CPU), hw=HardwareProfile(**hw),
                 par=tmm.Parallelism(e=e, b=b), **kw)
    assert (tt.par.e, tt.par.b) == (jt.par.e, jt.par.b) == (e, b)
    assert tt._rows == slice(0, 8)                  # the rows still from the mesh
    np.testing.assert_allclose(tt.mact.static, jt.mact.static, rtol=1e-12)
    if static is not None:
        assert tt.mact.static == static
    assert tt.choose_chunks() == jt.choose_chunks()
    assert tuple(tt.choose_schedule()) == tuple(jt.choose_schedule())
    load = np.random.default_rng(e).integers(0, 4000, 8).astype(np.float64)
    tt._last_load = jt._last_load = load
    assert tt.choose_chunks() == jt.choose_chunks()


# ---------------------------------------------------------------------------
# memory model, config and dispatch hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jregistry()))
def test_active_params_and_remainder_layers_match_jax(arch):
    jc, tc = jregistry()[arch], registry()[arch]
    assert tmm.active_params(tc) == jmm.active_params(jc)
    assert tmm.total_params(tc) == jmm.total_params(jc)
    assert tc.remainder_layers == jc.remainder_layers
    for layers in (1, 2, 3, 7):
        assert (dataclasses.replace(tc, num_layers=layers).remainder_layers
                == dataclasses.replace(jc, num_layers=layers).remainder_layers)
    if tc.moe is not None:
        assert tmm.active_params(tc) < tmm.total_params(tc)


@pytest.mark.parametrize("T,K,G,cap,seed", [(16, 2, 4, 8, 0), (16, 2, 4, 3, 1),
                                            (33, 1, 5, 4, 2), (7, 4, 8, 1, 3),
                                            (64, 2, 8, 64, 4)])
def test_make_plan_and_scatter_values_match_jax(T, K, G, cap, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, G, (T, K)).astype(np.int32)
    vals = rng.integers(-50, 50, (T, K)).astype(np.int32)
    jplan = jdsp.make_plan(jnp.asarray(idx), G, cap)
    tplan = tdsp.make_plan(torch.as_tensor(idx), G, cap)
    for name in ("slots", "load", "drops"):
        got, want = getattr(tplan, name), np.asarray(getattr(jplan, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for fill in (0, -1):
        want = jdsp.scatter_values(jnp.asarray(vals), jplan, G, cap, fill=fill)
        got = tdsp.scatter_values(torch.as_tensor(vals), tplan, G, cap, fill=fill)
        assert got.dtype == torch.int32 and tuple(got.shape) == (G, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the rows scatter through the same plan as the JAX package's
    x = rng.integers(-9, 9, (T, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tdsp.scatter_rows(torch.as_tensor(x), tplan, G, cap).numpy(),
        np.asarray(jdsp.scatter_rows(jnp.asarray(x), jplan, G, cap)))


# ---------------------------------------------------------------------------
# selective remat
# ---------------------------------------------------------------------------

def _remat_case(arch, policy):
    jc = dataclasses.replace(jregistry()[arch].reduced(), remat_policy=policy)
    tc = dataclasses.replace(get_config(arch).reduced(), remat_policy=policy)
    jp = jtf.init_params(jax.random.PRNGKey(0), jc)
    tp = make_train_state(params_from_jax(jax.tree.map(np.asarray, jp), tc, CPU)).params
    batch = SyntheticLMData(tc, 32, 2, seed=1).batch_at(0)
    return jc, tc, jp, tp, batch


@pytest.mark.parametrize("arch,fused", [("mixtral-8x7b", False), ("mixtral-8x7b", True),
                                        ("gemma3-27b", False)])
def test_selective_remat_matches_jax_grad(arch, fused):
    """Loss and every gradient at ``remat_policy="selective"`` against
    ``jax.grad`` of the JAX package's loss (its layer checkpointed with
    ``save_only_these_names("qkv")``); the fused case runs the EP leg at one
    peer in 2 chunks, whose per-chunk checkpoints nest inside the layer's."""
    jc, tc, jp, tp, batch = _remat_case(arch, "selective")
    if fused:
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                                 ("data", "model"))
        jctx = JCtx(mesh=mesh, moe_strategy="ep_shardmap", moe_fused=True, moe_chunks=2)
        tctx = DistContext(device=CPU, moe_strategy="ep_shardmap", moe_fused=True,
                           moe_chunks=2)
    else:
        jctx, tctx = JCtx(), DistContext(device=CPU)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jstep.loss_fn, has_aux=True),
                                 static_argnums=(1, 2))(jp, jc, jctx, jb)
    tloss, _ = loss_fn(tp, tc, tctx, tb)
    names, leaves = zip(*named_params(tp))
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    want = dict(named_params(params_from_jax(jax.tree.map(np.asarray, jgrads), tc, CPU)))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, tgrads):
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   err_msg=name)


class _Products(TorchDispatchMode):
    """Counts the products against a weight as stored, by the weight's group:
    ``x @ w`` (``aten.mm``) and ``qkv_proj``; a backward's product with the
    transpose (the input's gradient) is not one."""

    def __init__(self, groups: dict):
        super().__init__()
        self.groups, self.n = groups, dict.fromkeys(groups, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.repro_torch.qkv_proj.default):
            b = args[1]
            for name, ws in self.groups.items():
                self.n[name] += any(b.data_ptr() == w.data_ptr() and b.shape == w.shape
                                    and b.stride() == w.stride() for w in ws)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,qkv,wo", [("none", 1, 1), ("selective", 1, 2),
                                           ("full", 2, 2), ("memfine", 2, 2)])
def test_selective_remat_computes_the_qkv_projections_once(policy, qkv, wo):
    """One forward and backward of the reduced Mixtral (2 attention layers,
    3 projections each), counting each product against a weight: "none"
    keeps every activation (nothing runs twice); "selective" saves q, k and
    v and recomputes the rest of the layer, the output projection included;
    "full" and "memfine" recompute all of it.  Every policy's loss and
    gradients are the unchecked ones bit for bit, so ``qkv_proj``'s backward
    gives aten's."""
    _, tc, _, tp, batch = _remat_case("mixtral-8x7b", policy)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    names, leaves = zip(*named_params(tp))
    group = {n: n.split("/")[-1] for n in names}
    count = _Products({g: [p for n, p in zip(names, leaves) if group[n] in members]
                       for g, members in (("qkv", ("wq", "wk", "wv")), ("wo", ("wo",)))})
    blocks.qkv_proj.runs = 0
    with count:
        loss, _ = loss_fn(tp, tc, DistContext(device=CPU), tb)
        assert count.n == {"qkv": 2 * 3, "wo": 2}
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert count.n == {"qkv": 2 * 3 * qkv, "wo": 2 * wo}
    # the op the policy saves is used under "selective" only
    assert blocks.qkv_proj.runs == (2 * 3 if policy == "selective" else 0)
    _, tc0, _, tp0, _ = _remat_case("mixtral-8x7b", "none")
    loss0, _ = loss_fn(tp0, tc0, DistContext(device=CPU), tb)
    grads0 = torch.autograd.grad(loss0, [p for _, p in named_params(tp0)],
                                 allow_unused=True)
    assert torch.equal(loss, loss0)
    for g, g0 in zip(grads, grads0):
        assert (g is None) == (g0 is None) and (g is None or torch.equal(g, g0))


def test_an_unknown_remat_policy_raises():
    _, tc, _, tp, batch = _remat_case("mixtral-8x7b", "dots")
    with pytest.raises(ValueError, match="remat_policy 'dots'"):
        loss_fn(tp, tc, DistContext(device=CPU),
                {k: torch.as_tensor(v) for k, v in batch.items()})
