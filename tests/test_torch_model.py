"""The port's model forms against the JAX package at ``mixtral-8x7b.reduced()``
in fp32: single-pass prefill with its cache, chunked extension and decode.

Weights come from the JAX init through ``bridge.params_from_jax``; prompts
from a seeded numpy generator.  The reduced config's window is 64 tokens, so
prompts past 64 exercise the ring cache.  Logits and every cache tensor agree
to 1e-4 (fp32, sums in another order over several layers)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import GPU_64G as JAX_GPU_64G  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import GPU_64G, get_config  # noqa: E402
from repro_torch.core import memory_model as tmm  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)


def _setup(layers=None, seed=0):
    jcfg = registry()["mixtral-8x7b"].reduced()
    tcfg = get_config("mixtral-8x7b").reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    return jcfg, tcfg, jp, tp


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _assert_cache_close(t_cache, j_cache, cfg, B):
    want = cache_from_jax(jax.tree.map(np.asarray, j_cache), cfg, B, CPU)
    assert t_cache["pos"].tolist() == want["pos"].tolist()
    for got_l, want_l in zip(t_cache["layers"], want["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(got_l["attn"][name].numpy(),
                                       want_l["attn"][name].numpy(), **TOL)


def test_layer_specs_and_reduction_match_jax():
    for jcfg, tcfg in ((registry()["mixtral-8x7b"], get_config("mixtral-8x7b")),
                       (registry()["mixtral-8x7b"].reduced(),
                        get_config("mixtral-8x7b").reduced())):
        assert repr(jcfg.layer_specs()) == repr(tcfg.layer_specs())
        assert (jcfg.padded_vocab, jcfg.resolved_head_dim, jcfg.d_model) == (
            tcfg.padded_vocab, tcfg.resolved_head_dim, tcfg.d_model)


@pytest.mark.parametrize("layers", [None, 4])
def test_init_params_shapes_match_jax(layers):
    _, tcfg, jp, tp = _setup(layers)
    mine = ttf.init_params(tcfg, device=CPU, seed=5)
    got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                       mine)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                        tp)
    assert got == want


@pytest.mark.parametrize("S,cache_len", [(24, 48), (96, 128)])
def test_prefill_logits_and_cache_match_jax(S, cache_len):
    jcfg, tcfg, jp, tp = _setup()
    toks = _tokens(2, S, jcfg.vocab_size)
    jl, jst, jc = jtf.forward(jp, jcfg, JCtx(), {"tokens": jnp.asarray(toks)},
                              return_cache=True, cache_len=cache_len)
    with torch.no_grad():
        tl, tst, tc = ttf.forward(tp, tcfg, TCTX,
                                  {"tokens": torch.from_numpy(toks).long()},
                                  return_cache=True, cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tst["load_per_layer"].tolist() == np.asarray(jst["load_per_layer"]).tolist()
    _assert_cache_close(tc, jc, tcfg, 2)


@pytest.mark.parametrize("S,C,cache_len", [(16, 16, 96), (48, 24, 128)])
def test_extend_and_decode_steps_match_jax(S, C, cache_len):
    """Prefill S tokens, extend by one C-token chunk, then decode 4 tokens;
    at (48, 24, 128) the extension crosses the 64-slot ring's wrap."""
    jcfg, tcfg, jp, tp = _setup()
    toks = _tokens(2, S + C + 4, jcfg.vocab_size)
    _, _, jc = jtf.forward(jp, jcfg, JCtx(), {"tokens": jnp.asarray(toks[:, :S])},
                           return_cache=True, cache_len=cache_len)
    with torch.no_grad():
        _, _, tc = ttf.forward(tp, tcfg, TCTX,
                               {"tokens": torch.from_numpy(toks[:, :S]).long()},
                               return_cache=True, cache_len=cache_len)
        jl, jc = jtf.extend_step(jp, jcfg, JCtx(), jc, jnp.asarray(toks[:, S:S + C]))
        tl, tc = ttf.extend_step(tp, tcfg, TCTX, tc,
                                 torch.from_numpy(toks[:, S:S + C]).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(tc, jc, tcfg, 2)
        for i in range(S + C, S + C + 4):
            jl, jc = jtf.decode_step(jp, jcfg, JCtx(), jc,
                                     jnp.asarray(toks[:, i:i + 1]))
            tl, tc = ttf.decode_step(tp, tcfg, TCTX, tc,
                                     torch.from_numpy(toks[:, i:i + 1]).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_cache_close(tc, jc, tcfg, 2)


def test_decode_rows_at_different_positions():
    """Rows of one decode batch at their own positions give what each row
    gives decoded alone -- what the scheduler's slot pool relies on."""
    _, tcfg, _, tp = _setup()
    toks = torch.from_numpy(_tokens(2, 80, tcfg.vocab_size)).long()
    with torch.no_grad():
        _, _, c0 = ttf.forward(tp, tcfg, TCTX, {"tokens": toks[:1, :20]},
                               return_cache=True, cache_len=96)
        _, _, c1 = ttf.forward(tp, tcfg, TCTX, {"tokens": toks[1:, :70]},
                               return_cache=True, cache_len=96)
        both = {"pos": torch.cat([c0["pos"], c1["pos"]]),
                "layers": [{"attn": {n: torch.cat([a["attn"][n], b["attn"][n]])
                                     for n in ("k", "v")}}
                           for a, b in zip(c0["layers"], c1["layers"])]}
        nxt = torch.stack([toks[0, 20:21], toks[1, 70:71]])
        lb, _ = ttf.decode_step(tp, tcfg, TCTX, both, nxt)
        l0, _ = ttf.decode_step(tp, tcfg, TCTX, c0, nxt[:1])
        l1, _ = ttf.decode_step(tp, tcfg, TCTX, c1, nxt[1:])
    torch.testing.assert_close(lb, torch.cat([l0, l1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("requests,decode,prefill", [(1, 4, 16), (3, 4, 64),
                                                     (8, 8, 0)])
def test_serving_peak_bytes_matches_jax(reduced, requests, decode, prefill):
    jcfg, tcfg = registry()["mixtral-8x7b"], get_config("mixtral-8x7b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    kw = dict(requests=requests, cache_len=88, decode_tokens=decode,
              prefill_tokens=prefill)
    assert tmm.serving_peak_bytes(tcfg, **kw) == jmm.serving_peak_bytes(jcfg, **kw)
    assert tmm.serving_fits(tcfg, GPU_64G, **kw) == jmm.serving_fits(
        jcfg, JAX_GPU_64G, **kw)
