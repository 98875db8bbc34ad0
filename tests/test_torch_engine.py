"""The port's compiled-step engine against the JAX package's at
``mixtral-8x7b.reduced()`` in fp32.

On the CPU a compiled step runs its eager function, as the JAX engine jits
without donation on the CPU; its CUDA graphs are tested on the card in
``tests/test_torch_cuda.py``.  What holds here: the step cache's keys and
counts, ``prefill_replay`` and the single-pass prefill against the JAX
package's, the scheduler's eager and compiled modes against each other and
the JAX scheduler, and the in-place cache positions a graph relies on.

Tolerances: the replay's logits and caches 1e-4 against JAX (fp32 products
summed in another order in another framework, over two layers); the port's
own single-pass prefill against its replay as the JAX package holds its own
(``tests/test_serving.py::test_prefill_matches_replay``: cache 1e-5,
logits 2e-4).  Token streams, positions and counts must be equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import scheduler as jsch  # noqa: E402
from repro_torch.bridge import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402

CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
# the trace of tests/test_torch_serving.py: (prompt length, generated tokens)
TRACE = [(16, 8), (48, 24), (32, 12), (20, 40), (64, 10), (8, 5)]


@pytest.fixture(scope="module")
def models():
    jcfg = registry()["mixtral-8x7b"].reduced()
    tcfg = get_config("mixtral-8x7b").reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _cache_trace(eng, cfg, ctx, params, tokens, bf16):
    """The step cache's entry count after each call of one fixed sequence."""
    eng.clear_step_cache()
    counts = [eng.step_cache_info()["entries"]]
    decode = eng.get_decode_step(cfg, ctx)
    assert eng.get_decode_step(cfg, ctx) is decode
    counts.append(eng.step_cache_info()["entries"])
    assert eng.get_extend_step(cfg, ctx) is eng.get_extend_step(cfg, ctx)
    counts.append(eng.step_cache_info()["entries"])
    prefill = eng.get_prefill_fn(cfg, ctx, 32)
    assert eng.get_prefill_fn(cfg, ctx, 32) is prefill
    assert eng.get_prefill_fn(cfg, ctx, 48) is not prefill
    assert eng.get_prefill_fn(cfg, ctx, 32, bf16) is not prefill
    counts.append(eng.step_cache_info()["entries"])
    eng.prefill(params, cfg, ctx, {"tokens": tokens}, 32)
    eng.generate(params, cfg, ctx, {"tokens": tokens}, steps=2, cache_len=40)
    counts.append(eng.step_cache_info()["entries"])
    eng.prefill_chunked(params, cfg, ctx, tokens, 32, 4)
    counts.append(eng.step_cache_info()["entries"])
    eng.clear_step_cache()
    counts.append(eng.step_cache_info()["entries"])
    return counts


def test_step_cache_counts_follow_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = _cache_trace(jeng, jcfg, JCtx(), jp, jnp.asarray(toks), jnp.bfloat16)
    got = _cache_trace(teng, tcfg, TCTX, tp, torch.from_numpy(toks).long(),
                       torch.bfloat16)
    assert got == want == [0, 1, 2, 5, 6, 6, 0]


@pytest.mark.parametrize("S", [24, 96])    # 96: the 64-token window's ring wraps
def test_prefill_replay_matches_jax_and_single_pass_prefill(models, S):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(S).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    cache_len = S + 8
    jl, jc = jeng.prefill_replay(jp, jcfg, JCtx(), {"tokens": jnp.asarray(toks)},
                                 cache_len)
    batch = {"tokens": torch.from_numpy(toks).long()}
    tl, tc = teng.prefill_replay(tp, tcfg, TCTX, batch, cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    want = cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, 2, CPU)
    assert tc["pos"].tolist() == want["pos"].tolist() == [S, S]
    got_leaves, want_leaves = teng.leaves(tc), teng.leaves(want)
    assert [t.shape for t in got_leaves] == [t.shape for t in want_leaves]
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)

    pl, pc = teng.prefill(tp, tcfg, TCTX, batch, cache_len)
    assert pc["pos"].tolist() == [S, S]
    for a, b in zip(teng.leaves(pc), got_leaves):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), tl.numpy(), rtol=2e-4, atol=2e-4)


def _requests(mod, prompts):
    return [mod.Request(rid=i, tokens=p, max_new_tokens=g)
            for i, (p, (_, g)) in enumerate(zip(prompts, TRACE))]


def test_eager_and_compiled_schedulers_match_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, S).astype(np.int32) for S, _ in TRACE]
    jreqs = _requests(jsch, prompts)
    jsched = jsch.ContinuousBatchingScheduler(
        jp, jcfg, JCtx(), jsch.ServeConfig(max_slots=2, cache_len=80,
                                           prefill_chunk=16))
    jm = jsched.run(jreqs)
    for eager in (True, False):
        treqs = _requests(tsch, prompts)
        tsched = tsch.ContinuousBatchingScheduler(
            tp, tcfg, TCTX, tsch.ServeConfig(max_slots=2, cache_len=80,
                                             prefill_chunk=16), eager=eager)
        tm = tsched.run(treqs)
        assert [r.out for r in treqs] == [r.out for r in jreqs], eager
        assert tsched.admission_order == jsched.admission_order
        for key in ("decode_waves", "prefill_chunks", "generated_tokens"):
            assert tm[key] == jm[key], (eager, key)


def test_steps_advance_the_cache_positions_in_place(models):
    _, tcfg, _, tp = models
    cache = teng.init_serve_cache(tp, tcfg, 2, 40)
    pos = cache["pos"]
    toks = torch.tensor([[3], [5]])
    _, cache = teng.get_decode_step(tcfg, TCTX)(tp, cache, toks)
    assert cache["pos"] is pos and pos.tolist() == [1, 1]
    _, cache = teng.get_extend_step(tcfg, TCTX)(tp, cache, torch.tensor([[1, 2, 3]] * 2))
    assert cache["pos"] is pos and pos.tolist() == [4, 4]
    # the scheduler's slot pool keeps its tensors across waves, as a
    # captured decode graph needs
    sched = tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=2, cache_len=40, prefill_chunk=8))
    before = teng.leaves(sched.cache)
    sched.run([tsch.Request(rid=0, tokens=np.arange(12, dtype=np.int32),
                            max_new_tokens=4)])
    assert all(a is b for a, b in zip(teng.leaves(sched.cache), before))
    assert sched.decode_waves == 3
