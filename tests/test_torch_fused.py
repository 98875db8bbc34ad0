"""The port's ragged matmul and fused MoE kernels (CPU path), the fused
expert leg's gradients and the EP MoE layer against the JAX package.

Kernels against the Pallas kernels in interpret mode, at the shapes of
``tests/test_fused_moe.py``: ``ragged_matmul`` bitwise equal on
integer-valued inputs, 1e-5 on Gaussian ones.  ``fused_moe`` takes a silu,
whose last bit differs between the two libraries' exp, so it is held to
1e-5 of the output's largest magnitude even on integer inputs; its row-side plain version equals the
slot-side reference bit for bit.  ``ops.moe_ffn`` forward and
every gradient (weighted and unweighted) against ``jax.grad`` of the JAX
custom VJP to 1e-4.  The EP layer at one peer with the fused leg, chunks 2
and depth 2, against the JAX package on a 1x1 mesh: output to 1e-5, load,
drops exactly, aux loss to 1e-5; its gradients to 1e-4."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import dispatch as jdsp  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.fused_moe import fused_moe as j_fused_moe  # noqa: E402
from repro.kernels.ragged_mlp import ragged_matmul as j_ragged_matmul  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.fused_moe import fused_moe as t_fused_moe  # noqa: E402
from repro_torch.kernels.ragged_mlp import ragged_matmul as t_ragged_matmul  # noqa: E402

CPU = torch.device("cpu")
# the suite runs several test processes on one host; PyTorch's default of a
# thread per core in each of them oversubscribes the cores many times over
torch.set_num_threads(min(torch.get_num_threads(), 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(T=24, K=2, E=4, d=16, f=16, bm=8, seed=0, exact=True, skew=False):
    rng = np.random.default_rng(seed)
    if skew:        # 3/4 of the tokens on expert 0
        topk = np.stack([(0 if t % 4 else rng.integers(1, E), rng.integers(1, E))
                         for t in range(T)])[:, :K]
    else:
        topk = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
    R = -(-(T * K + E * bm) // bm) * bm
    plan = jdsp.make_ragged_plan(jnp.asarray(topk, jnp.int32), E, R, bm)
    if exact:
        ints = lambda lo, hi, s: rng.integers(lo, hi, s).astype(np.float32)  # noqa: E731
        x, w1, w3, w2 = (ints(-8, 8, (T, d)), ints(-2, 2, (E, d, f)),
                         ints(-2, 2, (E, d, f)), ints(-2, 2, (E, f, d)))
        wtk = (2.0 ** rng.integers(-2, 2, (T, K))).astype(np.float32)
    else:
        g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
        x, w1, w3, w2 = g(T, d), g(E, d, f) * 0.3, g(E, d, f) * 0.3, g(E, f, d) * 0.3
        wtk = rng.random((T, K)).astype(np.float32)
    return plan, R, x, w1, w3, w2, wtk


def _row_maps(plan, weights, K, R):
    pos = jdsp.invert_slots(plan.slots, R)
    src = jnp.where(pos >= 0, pos // K, -1)
    wslot = jnp.where(pos >= 0, jnp.take(jnp.asarray(weights).reshape(-1),
                                         jnp.maximum(pos, 0)), 0.0)
    return src, wslot


def _check(got, want, exact, tol=1e-5):
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("exact,transpose", [(True, False), (False, False),
                                             (False, True)])
def test_ragged_matmul_matches_pallas(exact, transpose):
    plan, R, x, w1, _, _, _ = _case(seed=3, exact=exact)
    bm = 8
    xr = np.asarray(jdsp.scatter_rows_flat(jnp.asarray(x), plan.slots, R))
    w = np.ascontiguousarray(np.swapaxes(w1, 1, 2)) if transpose else w1
    want = j_ragged_matmul(jnp.asarray(xr), jnp.swapaxes(jnp.asarray(w), 1, 2)
                           if transpose else jnp.asarray(w),
                           plan.block_to_expert, plan.total_rows, block_m=bm,
                           interpret=True)
    got = t_ragged_matmul(_t(xr), _t(w), _t(plan.block_to_expert),
                          _t(plan.total_rows), bm, transpose_w=transpose)
    _check(got, want, exact)
    assert (got[int(plan.total_rows):] == 0).all()


def test_ragged_expert_ffn_ref_matches_jax():
    """The plain ragged SwiGLU FFN (the non-fused leg's reference) against
    the JAX package's."""
    from repro.kernels import ref as jref
    plan, R, x, w1, w3, w2, _ = _case(seed=4, exact=False)
    xr = np.asarray(jdsp.scatter_rows_flat(jnp.asarray(x), plan.slots, R))
    want = jref.ragged_expert_ffn_ref(*(jnp.asarray(a) for a in (xr, w1, w3, w2)),
                                      plan.block_to_expert, plan.total_rows)
    got = tref.ragged_expert_ffn_ref(*(_t(a) for a in (xr, w1, w3, w2)),
                                     _t(plan.block_to_expert), _t(plan.total_rows))
    _check(got, want, exact=False)


@pytest.mark.parametrize("exact,skew,weighted", [(True, False, True),
                                                 (True, True, False),
                                                 (False, False, True)])
def test_fused_moe_matches_pallas(exact, skew, weighted):
    plan, R, x, w1, w3, w2, wtk = _case(seed=1 + skew, exact=exact, skew=skew)
    src, wslot = _row_maps(plan, wtk, 2, R)
    wj = wslot if weighted else None
    want = j_fused_moe(*(jnp.asarray(a) for a in (x, w1, w3, w2)), src, wj,
                       plan.total_rows, plan.block_to_expert, interpret=True)
    got = t_fused_moe(*(_t(a) for a in (x, w1, w3, w2)), _t(src),
                      None if wj is None else _t(wj), _t(plan.total_rows),
                      _t(plan.block_to_expert))
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale
    # the row-side plain version is the slot-side reference, reordered
    ref = tref.fused_moe_ref(*(_t(a) for a in (x, w1, w3, w2)), _t(src),
                             _t(plan.slots), _t(plan.block_to_expert),
                             _t(plan.total_rows), _t(wtk) if weighted else None)
    _check(got, ref.numpy(), exact)


@pytest.mark.parametrize("weighted", [True, False])
def test_moe_ffn_grads_match_jax(weighted):
    """Forward and every gradient of the fused leg against jax.grad of the
    JAX package's custom VJP (Pallas kernels in interpret mode)."""
    plan, R, x, w1, w3, w2, wtk = _case(T=16, d=16, f=32, seed=5, exact=False,
                                        skew=True)
    bm = 8
    args = [x, w1, w3, w2] + ([wtk] if weighted else [])

    def jloss(x, w1, w3, w2, *w):
        y = jops.moe_ffn(x, w1, w3, w2, plan.slots, plan.block_to_expert,
                         plan.total_rows, w[0] if w else None, block_m=bm,
                         use_pallas=True, interpret=True)
        return (y ** 2).sum(), y

    (_, yj), gj = jax.value_and_grad(jloss, argnums=tuple(range(len(args))),
                                     has_aux=True)(*(jnp.asarray(a) for a in args))
    targs = [_t(a).requires_grad_() for a in args]
    yt = tops.moe_ffn(*targs[:4], _t(plan.slots), _t(plan.block_to_expert),
                      _t(plan.total_rows), targs[4] if weighted else None, block_m=bm)
    (yt ** 2).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)
    for got, want in zip(targs, gj):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the EP MoE layer at one peer
# ---------------------------------------------------------------------------

def _layer_case(top_k=2):
    jcfg = JMoEConfig(num_experts=4, top_k=top_k, d_ff_expert=32)
    tcfg = MoEConfig(num_experts=4, top_k=top_k, d_ff_expert=32)
    params = jmoe.init_moe(jax.random.PRNGKey(0), 16, jcfg)
    w = np.array(params["router"]["w"])
    w[:, 0] += 1.0                            # uneven expert loads
    params["router"]["w"] = jnp.asarray(w)
    x = np.random.default_rng(1).standard_normal((2, 16, 16)).astype(np.float32)
    return jcfg, tcfg, params, x


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("chunks,depth,fused", [(2, 2, True), (2, 1, False)])
def test_ep_layer_matches_jax_on_one_peer(chunks, depth, fused):
    jcfg, tcfg, params, x = _layer_case()
    jctx = jmoe.DistContext(mesh=_mesh(), moe_strategy="ep_shardmap",
                            moe_chunks=chunks, pipeline_chunks=depth,
                            moe_fused=fused)
    y_j, st_j = jmoe.moe_ffn(params, jnp.asarray(x), jcfg, jctx)
    tp = jax.tree.map(_t, params)
    tctx = tmoe.DistContext(device=CPU, moe_strategy="ep_shardmap",
                            moe_chunks=chunks, pipeline_chunks=depth,
                            moe_fused=fused)
    y_t, st_t = tmoe.moe_ffn(tp, _t(x), tcfg, tctx)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert st_t["load"].tolist() == np.asarray(st_j["load"]).tolist()
    assert float(st_t["drops"]) == float(st_j["drops"]) == 0.0
    np.testing.assert_allclose(float(st_t["aux_loss"]), float(st_j["aux_loss"]),
                               rtol=1e-5)


def test_ep_layer_grads_match_jax_and_the_dense_oracle():
    """Gradients of the whole fused EP layer (chunks 2, depth 2, per-chunk
    recompute) against jax.grad of the JAX layer on the 1x1 mesh; the
    port's dense oracle gives the same expert-weight gradients (its aux
    loss is taken over all tokens, not per chunk, so its router gradient
    differs by design)."""
    jcfg, tcfg, params, x = _layer_case()
    jctx = jmoe.DistContext(mesh=_mesh(), moe_strategy="ep_shardmap",
                            moe_chunks=2, pipeline_chunks=2, moe_fused=True)

    def jloss(p):
        y, st = jmoe.moe_ffn(p, jnp.asarray(x), jcfg, jctx)
        return (y ** 2).sum() + st["aux_loss"]

    want = jax.grad(jloss)(params)
    tp = jax.tree.map(lambda a: _t(a).requires_grad_(), params)
    for ctx_kw in ({"moe_strategy": "ep_shardmap", "moe_chunks": 2,
                    "pipeline_chunks": 2, "moe_fused": True},
                   {"moe_strategy": "dense"}):
        for leaf in jax.tree.leaves(tp):
            leaf.grad = None
        y, st = tmoe.moe_ffn(tp, _t(x), tcfg, tmoe.DistContext(device=CPU, **ctx_kw))
        ((y ** 2).sum() + st["aux_loss"]).backward()
        for name in ("w1", "w3", "w2"):
            np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(want[name]),
                                       rtol=1e-4, atol=1e-4)
        if ctx_kw["moe_strategy"] == "ep_shardmap":
            np.testing.assert_allclose(tp["router"]["w"].grad.numpy(),
                                       np.asarray(want["router"]["w"]),
                                       rtol=1e-4, atol=1e-4)
