"""The decoder-only configs the port carries beside Mixtral, against the JAX
package at ``.reduced()`` in fp32: the paper's own DeepSeek-V3 cuts
(Model I and II: a dense prefix, 256-expert top-8 MoE with a shared expert
and loss-free bias balancing), Llama-4-Scout (chunked local attention, a
NoPE global layer, a shared expert), Gemma-3 (window and global attention,
qk-norm, tied embeddings), Llama-3.2-3B, Yi-9B and StarCoder2-3B.

Each config's module is the JAX package's, field for field; weights come
from the JAX init through ``bridge.params_from_jax``.  Prefill logits and
4 greedy decode steps: logits to rtol = atol = 1e-4 (the port's ``TOL``),
tokens and routed loads exactly."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.core.moe import DistContext as JCtx  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.core.moe import DistContext  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
TCTX = DistContext(device=CPU)
JCTX = JCtx()
ARCHS = ("deepseek-mini-16l", "deepseek-mini-8l", "llama4-scout-17b-a16e",
         "gemma3-27b", "llama3.2-3b", "yi-9b", "starcoder2-3b")
_j_forward = jax.jit(jtf.forward, static_argnums=(1, 2),
                     static_argnames=("return_cache", "cache_len"))
_j_decode = jax.jit(jtf.decode_step, static_argnums=(1, 2))


# configs of the port alone: DeepSeek-V3 with latent attention, which the
# reference has no layer for (tests/test_torch_deepseek.py)
PORT_ONLY = ("deepseek-v3", "deepseek-v3-ep32")


def _as_reference(cfg) -> dict:
    """``cfg`` as a dict of the reference's fields only, after checking that
    every field the port adds (``mla``, ``yarn``, and the router's and the
    held share's on ``moe``) holds its default: the model the reference
    means."""
    d = dataclasses.asdict(cfg)
    assert (d.pop("mla"), d.pop("yarn")) == (None, None), cfg.name
    if d["moe"] is not None:
        extra = {k: d["moe"].pop(k) for k in ("scoring", "n_group", "topk_group",
                                              "routed_scaling_factor", "experts_held")}
        assert extra == {"scoring": "softmax", "n_group": 1, "topk_group": 1,
                         "routed_scaling_factor": 1.0, "experts_held": 0}, cfg.name
    return d


def test_the_registry_holds_every_decoder_config_of_the_reference():
    """The port's registry is the reference's, name for name, every config
    field for field and its reduction too (the encoder and patch-input
    configs included); the fields only the port has hold their defaults,
    and the port adds only its DeepSeek-V3 configs."""
    mine, ref = tregistry(), registry()
    assert sorted(mine) == sorted([*ref, *PORT_ONLY])
    for name, cfg in mine.items():
        if name in PORT_ONLY:
            continue
        assert _as_reference(cfg) == dataclasses.asdict(ref[name]), name
        assert _as_reference(cfg.reduced()) == \
            dataclasses.asdict(ref[name].reduced()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    jcfg = registry()[arch].reduced()
    tcfg = get_config(arch).reduced()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
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
        jnext, tnext = jnp.argmax(jl[:, -1], -1), tl[:, -1].argmax(-1)
        for _ in range(4):
            assert tnext.tolist() == np.asarray(jnext).tolist()
            jl, jc = _j_decode(jp, jcfg, JCTX, jc, jnext[:, None].astype(jnp.int32))
            tl, tc = ttf.decode_step(tp, tcfg, TCTX, tc, tnext[:, None])
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            jnext, tnext = jnp.argmax(jl[:, -1], -1), tl[:, -1].argmax(-1)
