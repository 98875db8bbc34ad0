"""The port's three-launch ragged expert leg against the JAX package.

``ragged_swiglu`` (CPU path) against the Pallas kernel in interpret mode:
bitwise equal under exact arithmetic, 1e-5 on Gaussian inputs, with bm 8
and skewed routing that leaves dead blocks.  Exact arithmetic needs an exact
silu as well as exact sums, and silu is exact only where its sigmoid
saturates: the exact case scales w1 by 128, so every pre-activation is 0 or
at least 128 in magnitude.  ``ops.ragged_expert_ffn`` forward and its four
gradients against ``jax.grad`` of the JAX custom VJP (Pallas kernels in
interpret mode), fp32, 1e-5.  The EP layer with ``moe_ragged=True`` at one
peer against the JAX EP layer on a 1x1 mesh: output to 1e-5, load and drops
exactly, gradients against ``jax.grad`` to 1e-4, and equal to the port's
fused leg, which computes the same function.  Two trainer steps on the
ragged leg against the JAX trainer: losses and metrics to 1e-4, the same
schedules, step-1 parameters to 1e-4."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import dispatch as jdsp  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ragged_mlp import ragged_swiglu as j_ragged_swiglu  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import H100_80G, get_config  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ragged_mlp import ragged_swiglu as t_ragged_swiglu  # noqa: E402
from repro_torch.optim.adamw import named_params  # noqa: E402
from repro_torch.training.step import make_train_state  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")
# the suite runs several test processes on one host; PyTorch's default of a
# thread per core in each of them oversubscribes the cores many times over
torch.set_num_threads(min(torch.get_num_threads(), 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(T=24, K=2, E=4, d=16, f=16, bm=8, seed=0, exact=True, skew=False):
    """A routed ragged layout and its dispatched rows: (plan, R, rows, w1,
    w3, w2)."""
    rng = np.random.default_rng(seed)
    if skew:        # 3/4 of the tokens on expert 0: expert 3 may get none
        topk = np.stack([(0 if t % 4 else rng.integers(1, E), rng.integers(1, E - 1))
                         for t in range(T)])[:, :K]
    else:
        topk = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
    R = -(-(T * K + E * bm) // bm) * bm
    plan = jdsp.make_ragged_plan(jnp.asarray(topk, jnp.int32), E, R, bm)
    if exact:
        ints = lambda lo, hi, s: rng.integers(lo, hi, s).astype(np.float32)  # noqa: E731
        x, w1, w3, w2 = (ints(-8, 8, (T, d)), 128 * ints(-1, 2, (E, d, f)),
                         ints(-2, 2, (E, d, f)), ints(-2, 2, (E, f, d)))
    else:
        g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
        x, w1, w3, w2 = g(T, d), g(E, d, f) * 0.3, g(E, d, f) * 0.3, g(E, f, d) * 0.3
    rows = np.asarray(jdsp.scatter_rows_flat(jnp.asarray(x), plan.slots, R))
    return plan, R, rows, w1, w3, w2


@pytest.mark.parametrize("exact,skew", [(True, False), (True, True), (False, True)])
def test_ragged_swiglu_matches_pallas(exact, skew):
    bm = 8
    plan, R, rows, w1, w3, _ = _rows(seed=2 + skew, exact=exact, skew=skew)
    live = int(plan.total_rows)
    if skew:
        assert live < R - bm           # dead blocks past the routed load
    want = j_ragged_swiglu(*(jnp.asarray(a) for a in (rows, w1, w3)),
                           plan.block_to_expert, plan.total_rows, block_m=bm,
                           interpret=True)
    got = t_ragged_swiglu(*(_t(a) for a in (rows, w1, w3)), _t(plan.block_to_expert),
                          _t(plan.total_rows), bm)
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert np.abs(np.asarray(want)).max() > 128   # silu saturated, not all 0
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got[live:] == 0).all()


def test_ragged_expert_ffn_grads_match_jax():
    """Forward and the gradients of x, w1, w3, w2 against jax.grad of the
    JAX package's custom VJP (Pallas kernels in interpret mode)."""
    bm = 8
    plan, R, rows, w1, w3, w2 = _rows(T=16, f=32, seed=5, exact=False, skew=True)
    gy = np.random.default_rng(6).standard_normal((R, 16)).astype(np.float32)

    def jloss(x, w1, w3, w2):
        y = jops.ragged_expert_ffn(x, w1, w3, w2, plan.block_to_expert,
                                   plan.total_rows, block_m=bm, use_pallas=True,
                                   interpret=True)
        return (y * gy).sum(), y

    args = (rows, w1, w3, w2)
    (_, yj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_() for a in args]
    yt = tops.ragged_expert_ffn(*leaves, _t(plan.block_to_expert),
                                _t(plan.total_rows), block_m=bm)
    (yt * _t(gy)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("x", "w1", "w3", "w2"), leaves, gj):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert (leaves[0].grad[int(plan.total_rows):] == 0).all()


# ---------------------------------------------------------------------------
# the EP MoE layer at one peer on the ragged leg
# ---------------------------------------------------------------------------

def _layer_case():
    jcfg = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    tcfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    params = jmoe.init_moe(jax.random.PRNGKey(0), 16, jcfg)
    w = np.array(params["router"]["w"])
    w[:, 0] += 1.0                            # uneven expert loads
    params["router"]["w"] = jnp.asarray(w)
    x = np.random.default_rng(1).standard_normal((2, 16, 16)).astype(np.float32)
    return jcfg, tcfg, params, x


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("chunks,depth", [(2, 2), (2, 1)])
def test_ragged_ep_layer_matches_jax_and_the_fused_leg(chunks, depth):
    """Output, stats and every gradient of the ragged EP layer against the
    JAX layer on the 1x1 mesh (jax.grad), and against the port's fused leg."""
    jcfg, tcfg, params, x = _layer_case()
    jctx = jmoe.DistContext(mesh=_mesh(), moe_strategy="ep_shardmap",
                            moe_chunks=chunks, pipeline_chunks=depth, moe_ragged=True)

    def jloss(p):
        y, st = jmoe.moe_ffn(p, jnp.asarray(x), jcfg, jctx)
        return (y ** 2).sum() + st["aux_loss"], (y, st)

    (_, (y_j, st_j)), want = jax.value_and_grad(jloss, has_aux=True)(params)
    runs = {}
    for leg in ("ragged", "fused"):
        tp = jax.tree.map(lambda a: _t(a).requires_grad_(), params)
        tctx = tmoe.DistContext(device=CPU, moe_strategy="ep_shardmap",
                                moe_chunks=chunks, pipeline_chunks=depth,
                                moe_ragged=leg == "ragged", moe_fused=leg == "fused")
        y_t, st_t = tmoe.moe_ffn(tp, _t(x), tcfg, tctx)
        ((y_t ** 2).sum() + st_t["aux_loss"]).backward()
        runs[leg] = (y_t.detach(), st_t, tp)
    y_t, st_t, tp = runs["ragged"]
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert st_t["load"].tolist() == np.asarray(st_j["load"]).tolist()
    assert float(st_t["drops"]) == float(st_j["drops"]) == 0.0
    np.testing.assert_allclose(float(st_t["aux_loss"].detach()),
                               float(st_j["aux_loss"]), rtol=1e-5)
    for path, leaf in named_params(tp):
        # the router bias only selects experts: no gradient reaches it
        got = np.zeros(leaf.shape, np.float32) if leaf.grad is None else leaf.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(_at(want, path)),
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    y_f, st_f, tp_f = runs["fused"]
    np.testing.assert_allclose(y_t.numpy(), y_f.numpy(), rtol=1e-5, atol=1e-5)
    assert st_t["load"].tolist() == st_f["load"].tolist()
    for (path, a), (_, b) in zip(named_params(tp), named_params(tp_f)):
        assert (a.grad is None) == (b.grad is None), path
        if a.grad is not None:
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=path)


def _at(tree, path: str):
    for key in path.strip("/").split("/"):
        tree = tree[int(key) if isinstance(tree, list) else key]
    return tree


def test_trainer_on_the_ragged_leg_matches_jax():
    """Two steps of the reduced Mixtral on the EP strategy at one peer with
    the ragged leg and MACT on (planning with the dispatch buffer's Eq. 2
    term): the same losses, metrics, schedules and parameters."""
    jc, tc = registry()["mixtral-8x7b"].reduced(), get_config("mixtral-8x7b").reduced()
    seq, batch = 64, 2
    from repro.configs.base import HardwareProfile as JHardwareProfile
    j_h100 = JHardwareProfile(H100_80G.name, H100_80G.hbm_bytes, H100_80G.peak_flops,
                              H100_80G.hbm_bw, H100_80G.ici_bw, H100_80G.alpha)
    jt = jtrainer.Trainer(jc, jmoe.DistContext(mesh=_mesh(), moe_strategy="ep_shardmap",
                                               moe_ragged=True),
                          seq_len=seq, global_batch=batch, lr=1e-3, hw=j_h100)
    tt = Trainer(tc, tmoe.DistContext(device=CPU, moe_strategy="ep_shardmap",
                                      moe_ragged=True),
                 seq_len=seq, global_batch=batch, lr=1e-3)
    assert not tt.mact.fused and tt.mact.s_prime_max() == jt.mact.s_prime_max()
    jstate = jtrainer.init_train_state(jax.random.PRNGKey(0), jc)
    tstate = make_train_state(params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                              tc, CPU))
    jstate = jt.fit(1, jstate)
    tstate = tt.fit(1, tstate)
    got = params_from_jax(jax.tree.map(np.asarray, jstate.params), tc, CPU)
    flat_t = dict(named_params(tstate.params))
    for name, want in named_params(got):
        np.testing.assert_allclose(flat_t[name].detach().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    jt.fit(1, jstate)
    tt.fit(1, tstate)
    for key in ("loss", "ce", "aux", "grad_norm", "max_load", "drops"):
        np.testing.assert_allclose([r[key] for r in tt.log], [r[key] for r in jt.log],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert tt.chunk_trace == jt.chunk_trace
    assert tt.pipeline_trace == jt.pipeline_trace
