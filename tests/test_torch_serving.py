"""The port's serving engine and continuous-batching scheduler against the
JAX package at ``mixtral-8x7b.reduced()`` in fp32, greedy.

Token streams must be exactly equal; so must admission order and the
number of decode waves.  cache_len 80 against the 64-token window makes the
pool's caches rings, and the longer requests wrap them."""

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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import scheduler as tsch  # noqa: E402

CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
# (prompt length, generated tokens): 6 requests through 2 slots
TRACE = [(16, 8), (48, 24), (32, 12), (20, 40), (64, 10), (8, 5)]


@pytest.fixture(scope="module")
def models():
    jcfg = registry()["mixtral-8x7b"].reduced()
    tcfg = get_config("mixtral-8x7b").reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _prompts(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, S).astype(np.int32) for S, _ in TRACE]


def test_scheduler_streams_match_jax(models):
    jcfg, tcfg, jp, tp = models
    prompts = _prompts(jcfg.vocab_size)
    jreqs = [jsch.Request(rid=i, tokens=p, max_new_tokens=g)
             for i, (p, (_, g)) in enumerate(zip(prompts, TRACE))]
    treqs = [tsch.Request(rid=i, tokens=p, max_new_tokens=g)
             for i, (p, (_, g)) in enumerate(zip(prompts, TRACE))]
    jsched = jsch.ContinuousBatchingScheduler(
        jp, jcfg, JCtx(), jsch.ServeConfig(max_slots=2, cache_len=80,
                                           prefill_chunk=16))
    tsched = tsch.ContinuousBatchingScheduler(
        tp, tcfg, TCTX, tsch.ServeConfig(max_slots=2, cache_len=80,
                                         prefill_chunk=16))
    jm, tm = jsched.run(jreqs), tsched.run(treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tsched.admission_order == jsched.admission_order
    for key in ("requests", "generated_tokens", "decode_waves",
                "prefill_chunks", "max_occupancy"):
        assert tm[key] == jm[key], key
    assert tm["modeled_peak_bytes"] == jm["modeled_peak_bytes"]
    assert tm["nonfinite_logits"] == 0


def test_prefill_chunked_and_generate_match_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = jeng.prefill_chunked(jp, jcfg, JCtx(), jnp.asarray(toks), 96, 16)
    tl, tc = teng.prefill_chunked(tp, tcfg, TCTX, torch.from_numpy(toks).long(),
                                  96, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    want = jeng.generate(jp, jcfg, JCtx(), {"tokens": jnp.asarray(toks)},
                         steps=12, cache_len=96)
    got = teng.generate(tp, tcfg, TCTX, {"tokens": torch.from_numpy(toks).long()},
                        steps=12, cache_len=96)
    assert got.tolist() == np.asarray(want).tolist()


def test_scheduler_sampling_is_seeded_per_request(models):
    """temperature > 0: the same seed gives the same streams, whatever the
    slot count (each draw is seeded by request and position)."""
    _, tcfg, _, tp = models
    prompts = _prompts(tcfg.vocab_size)[:3]
    outs = []
    for slots in (1, 2, 2):
        reqs = [tsch.Request(rid=i, tokens=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        sched = tsch.ContinuousBatchingScheduler(
            tp, tcfg, TCTX, tsch.ServeConfig(max_slots=slots, cache_len=80,
                                             prefill_chunk=16, temperature=1.0))
        sched.run(reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1] == outs[2]
