"""The expert weights' gradient and the one gradient buffer per expert
weight that an EP layer's FCDA chunks share, against the JAX package.

``segment_outer`` (CPU path: ``ref.segment_outer_ref``) against the JAX
package's ``_segment_outer`` scan: bitwise equal on integer-valued inputs,
1e-5 on Gaussian ones, with bm 8 and 16, experts that get no rows and row
blocks past ``total_rows`` (which the port skips and the JAX scan adds as
zero rows).  The add into a buffer against the same expression in JAX,
bf16(old + bf16(sum)), bitwise.  The EP layer's weight and router gradients
at one peer against ``jax.grad`` of the JAX layer on a 1x1 mesh at (chunks,
depth) (1, 1), (2, 1), (4, 1) on both legs and (2, 2) on the ragged leg,
1e-4 (``tests/test_torch_fused.py`` holds (2, 2) on the fused leg).  And the
invariant itself: each expert weight's gradient is one buffer, written by
the first chunk whose backward runs and added into by every later one."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import dispatch as jdsp  # noqa: E402
from repro.core import moe as jmoe  # noqa: E402
from repro.kernels.ops import _segment_outer as j_segment_outer  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import moe as tmoe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.weight_grad import segment_outer  # noqa: E402
from repro_torch.optim.adamw import named_params  # noqa: E402

CPU = torch.device("cpu")
# the suite runs several test processes on one host; PyTorch's default of a
# thread per core in each of them oversubscribes the cores many times over
torch.set_num_threads(min(torch.get_num_threads(), 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _blocks(E=4, bm=8, K=24, N=40, T=20, seed=0, exact=True, empty=(), dead=2):
    """A routed ragged layout (experts in ``empty`` get no tokens) with
    ``dead`` row blocks past the routed ones, and (R, K), (R, N) row data:
    zero past total_rows as on the path (``a``, ``b``), and the same with
    nonzero rows there (``a_junk``, ``b_junk``)."""
    rng = np.random.default_rng(seed)
    experts = np.array([e for e in range(E) if e not in empty])
    topk = np.stack([rng.choice(experts, 2, replace=False) for _ in range(T)])
    R = (-(-(2 * T + E * bm) // bm) + dead) * bm
    plan = jdsp.make_ragged_plan(jnp.asarray(topk, jnp.int32), E, R, bm)
    if exact:
        a, b = (rng.integers(-4, 5, (R, n)).astype(np.float32) for n in (K, N))
    else:
        a, b = (rng.standard_normal((R, n)).astype(np.float32) for n in (K, N))
    live = (np.arange(R) < int(plan.total_rows))[:, None]
    a_junk = np.where(live, a, 7.0).astype(np.float32)
    b_junk = np.where(live, b, -3.0).astype(np.float32)
    return plan, R, np.where(live, a, 0.0), np.where(live, b, 0.0), a_junk, b_junk


@pytest.mark.parametrize("bm,exact,empty", [(8, True, ()), (16, True, (1,)),
                                            (8, False, (0, 3)), (16, False, ())])
def test_segment_outer_matches_the_jax_scan(bm, exact, empty):
    E = 4
    plan, R, a, b, a_junk, b_junk = _blocks(E=E, bm=bm, seed=bm + len(empty),
                                            exact=exact, empty=empty)
    assert int(plan.total_rows) <= R - 2 * bm        # dead blocks past the load
    want = np.asarray(j_segment_outer(jnp.asarray(a), jnp.asarray(b),
                                      plan.block_to_expert, E))
    before = segment_outer.launches
    # the port skips the dead blocks: their rows may hold anything
    got = segment_outer(_t(a_junk), _t(b_junk), _t(plan.block_to_expert),
                        _t(plan.total_rows), bm, torch.full((E, a.shape[1], b.shape[1]),
                                                            99.0),
                        accumulate=False)
    assert segment_outer.launches == before          # the CPU launches nothing
    for e in empty:
        assert (got[e] == 0).all()
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bm", [8, 16])
def test_segment_outer_adds_with_the_jax_rounding_points(bm):
    """bf16 rows and buffer: the add is bf16(float(old) + float(bf16(sum)));
    integer inputs and old values make every fp32 sum exact, and the sum
    is large enough that the two roundings both bite."""
    E = 4
    plan, R, a, b, _, _ = _blocks(E=E, bm=bm, seed=40 + bm, empty=(2,))
    a, b = 37 * a, 53 * b          # sums of up to ~1e5: past bf16's 8 bits
    old = np.random.default_rng(bm).integers(-3000, 3000, (E, a.shape[1], b.shape[1]))
    old_b = jnp.asarray(old, jnp.float32).astype(jnp.bfloat16)
    s = j_segment_outer(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                        plan.block_to_expert, E)
    want_w = s.astype(jnp.bfloat16)
    want_a = (old_b.astype(jnp.float32)
              + s.astype(jnp.bfloat16).astype(jnp.float32)).astype(jnp.bfloat16)
    args = (_t(a).bfloat16(), _t(b).bfloat16(), _t(plan.block_to_expert),
            _t(plan.total_rows), bm)
    out = _t(np.asarray(old_b.astype(jnp.float32))).bfloat16()
    got_a = segment_outer(*args, out.clone(), accumulate=True)
    got_w = segment_outer(*args, out.clone(), accumulate=False)
    for got, want in ((got_w, want_w), (got_a, want_a)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # the two roundings differ from one rounding of old + sum somewhere
    once = (old_b.astype(jnp.float32) + s).astype(jnp.bfloat16)
    assert not np.array_equal(np.asarray(once.astype(jnp.float32)),
                              got_a.float().numpy())


def test_segment_outer_checks_its_arguments():
    plan, R, a, b, _, _ = _blocks()
    args = (_t(plan.block_to_expert), _t(plan.total_rows), 8)
    out = torch.zeros((4, a.shape[1], b.shape[1]))
    with pytest.raises(ValueError, match="do not match"):
        segment_outer(_t(a), _t(b), *args, out[:, :8], accumulate=False)
    with pytest.raises(ValueError, match="blocks"):
        segment_outer(_t(a[:-8]), _t(b[:-8]), *args, out, accumulate=False)
    with pytest.raises(ValueError, match="one dtype"):
        segment_outer(_t(a).bfloat16(), _t(b), *args, out, accumulate=False)


# ---------------------------------------------------------------------------
# the EP layer's gradients, chunked
# ---------------------------------------------------------------------------

def _layer_case():
    jcfg = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    tcfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    params = jmoe.init_moe(jax.random.PRNGKey(3), 16, jcfg)
    w = np.array(params["router"]["w"])
    w[:, 0] += 1.0                            # uneven expert loads
    params["router"]["w"] = jnp.asarray(w)
    x = np.random.default_rng(4).standard_normal((2, 16, 16)).astype(np.float32)
    return jcfg, tcfg, params, x


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _at(tree, path: str):
    for key in path.strip("/").split("/"):
        tree = tree[int(key) if isinstance(tree, list) else key]
    return tree


@pytest.mark.parametrize("chunks,depth,leg", [(1, 1, "fused"), (2, 1, "fused"),
                                              (4, 1, "fused"), (1, 1, "ragged"),
                                              (2, 1, "ragged"), (4, 1, "ragged"),
                                              (2, 2, "ragged")])
def test_chunked_ep_layer_grads_match_jax(chunks, depth, leg):
    """Every gradient of the EP layer (the expert weights' from the shared
    buffers) against jax.grad of the JAX layer on the 1x1 mesh."""
    jcfg, tcfg, params, x = _layer_case()
    kw = {"moe_strategy": "ep_shardmap", "moe_chunks": chunks, "pipeline_chunks": depth,
          "moe_fused": leg == "fused", "moe_ragged": leg == "ragged"}

    def jloss(p):
        y, st = jmoe.moe_ffn(p, jnp.asarray(x), jcfg,
                             jmoe.DistContext(mesh=_mesh(), **kw))
        return (y ** 2).sum() + st["aux_loss"]

    want = jax.grad(jloss)(params)
    tp = jax.tree.map(lambda a: _t(a).requires_grad_(), params)
    y, st = tmoe.moe_ffn(tp, _t(x), tcfg, tmoe.DistContext(device=CPU, **kw))
    ((y ** 2).sum() + st["aux_loss"]).backward()
    for path, leaf in named_params(tp):
        # the router bias only selects experts: no gradient reaches it
        got = np.zeros(leaf.shape, np.float32) if leaf.grad is None else leaf.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(_at(want, path)), rtol=1e-4,
                                   atol=1e-4, err_msg=path)


@pytest.mark.parametrize("chunks,depth,leg", [(4, 1, "fused"), (4, 1, "ragged"),
                                              (2, 2, "ragged"), (1, 1, "fused")])
def test_chunks_share_one_gradient_buffer_per_expert_weight(monkeypatch, chunks, depth,
                                                            leg):
    """Each expert weight's gradient lives in one buffer for the whole
    layer: the first chunk's backward writes it, every later one adds into
    the same storage, and the weight's .grad is that buffer."""
    calls = []
    real = tops.segment_outer

    def spy(a, b, b2e, rows, block_m, out, *, accumulate, **kw):
        calls.append((out.data_ptr(), out.shape, accumulate))
        return real(a, b, b2e, rows, block_m, out, accumulate=accumulate, **kw)

    monkeypatch.setattr(tops, "segment_outer", spy)
    _, tcfg, params, x = _layer_case()
    tp = jax.tree.map(lambda a: _t(a).requires_grad_(), params)
    ctx = tmoe.DistContext(device=CPU, moe_strategy="ep_shardmap", moe_chunks=chunks,
                           pipeline_chunks=depth, moe_fused=leg == "fused",
                           moe_ragged=leg == "ragged")
    y, st = tmoe.moe_ffn(tp, _t(x), tcfg, ctx)
    ((y ** 2).sum() + st["aux_loss"]).backward()
    assert len(calls) == 3 * chunks
    for i, name in enumerate(("w1", "w3", "w2")):
        mine = calls[i::3]
        assert [acc for _, _, acc in mine] == [False] + [True] * (chunks - 1)
        assert {ptr for ptr, _, _ in mine} == {tp[name].grad.data_ptr()}
        assert mine[0][1] == tp[name].shape
