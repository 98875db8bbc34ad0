"""The port's dispatch/combine kernels (CPU path) and EP planners against the
JAX package.

Kernels against the Pallas kernels in interpret mode: bitwise equal on
integer-valued inputs with power-of-two weights (every product and sum is
exact), to 1e-5 on Gaussian inputs.  The transpose-symmetric gradients of
``dispatch_rows`` / ``combine_rows`` against ``jax.grad`` of the JAX
functions to 1e-4.  Plans: integer outputs exactly equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dispatch as jdsp  # noqa: E402
from repro.kernels import dispatch_pallas as jdp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import dispatch as tdsp  # noqa: E402
from repro_torch.kernels import dispatch_cuda as tdc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# the suite runs several test processes on one host; PyTorch's default of a
# thread per core in each of them oversubscribes the cores many times over
torch.set_num_threads(min(torch.get_num_threads(), 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, T=24, K=2, E=4, d=16, bm=8, exact=True):
    """The JAX kernel tests' shapes; integer-valued x and power-of-two
    weights when ``exact``, Gaussian otherwise."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    if exact:
        x = rng.integers(-8, 8, (T, d)).astype(np.float32)
        w = (2.0 ** rng.integers(-2, 2, (T, K))).astype(np.float32)
    else:
        x = rng.standard_normal((T, d)).astype(np.float32)
        w = rng.random((T, K)).astype(np.float32)
    R = -(-(T * K + E * bm) // bm) * bm
    plan = jdsp.make_ragged_plan(jnp.asarray(idx), E, R, bm)
    pos = jdsp.invert_slots(plan.slots, R)
    src = jnp.where(pos >= 0, pos // K, -1)
    return x, w, plan, R, src


def _check(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", range(2))
def test_scatter_rows_matches_pallas(seed, exact):
    x, _, plan, R, src = _case(seed, exact=exact)
    # per-row weights ride along, as in combine's backward
    wr = np.random.default_rng(seed + 9).integers(-2, 3, R).astype(np.float32)
    for weights in (None, wr):
        want = jdp.scatter_rows(jnp.asarray(x), src, plan.total_rows,
                                None if weights is None else jnp.asarray(weights),
                                interpret=True)
        got = tdc.scatter_rows(_t(x), _t(src), _t(plan.total_rows),
                               None if weights is None else _t(weights))
        _check(got, want, exact)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("seed", range(2))
def test_gather_combine_matches_pallas(seed, exact):
    x, w, plan, R, src = _case(seed, exact=exact)
    buf = jdp.scatter_rows(jnp.asarray(x), src, plan.total_rows, interpret=True)
    for weights in (None, w):
        want = jdp.gather_combine(buf, plan.slots,
                                  None if weights is None else jnp.asarray(weights),
                                  interpret=True)
        got = tdc.gather_combine(_t(buf), _t(plan.slots),
                                 None if weights is None else _t(weights))
        _check(got, want, exact)


def test_scatter_rows_zeroes_rows_past_total_rows():
    x, _, plan, R, src = _case(0)
    tr = int(plan.total_rows)
    poisoned = np.array(src)
    poisoned[tr:] = 0                    # live-looking sources past the load
    out = tdc.scatter_rows(_t(x), _t(poisoned), tr)
    assert (out[tr:] == 0).all() and (out[:tr] == tdc.scatter_rows(
        _t(x), _t(src), tr)[:tr]).all()


@pytest.mark.parametrize("seed", range(2))
def test_dispatch_combine_grads_match_jax(seed):
    """Forward and grads of dispatch_rows -> combine_rows against jax.grad
    of the JAX package's custom-VJP pair (Pallas, interpret mode)."""
    rng = np.random.default_rng(seed)
    T, K, E, d, bm = 16, 2, 4, 8, 4
    idx = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.random((T, K)).astype(np.float32)
    R = -(-(T * K + E * bm) // bm) * bm
    plan = jdsp.make_ragged_plan(jnp.asarray(idx), E, R, bm)

    def jloss(x, w):
        buf = jops.dispatch_rows(x, plan.slots, R, total_rows=plan.total_rows,
                                 use_pallas=True, interpret=True, block_m=bm)
        y = jops.combine_rows(buf * 2.0, plan.slots, w, plan.total_rows,
                              use_pallas=True, interpret=True, block_t=bm)
        return (y ** 2).sum(), y

    (lj, yj), gj = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    buf = tops.dispatch_rows(xt, _t(plan.slots), R, _t(plan.total_rows))
    yt = tops.combine_rows(buf * 2.0, _t(plan.slots), wt, _t(plan.total_rows))
    (yt ** 2).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)
    for got, want in ((xt.grad, gj[0]), (wt.grad, gj[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------

def _ids(seed, T, K, E, skew):
    rng = np.random.default_rng(seed)
    if skew:
        return np.minimum(rng.geometric(0.4, (T, K)) - 1, E - 1).astype(np.int32)
    return np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)


def _same(got, want):
    assert got.dtype == torch.int32, got.dtype
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("T,K,E,P,cap_send,skew", [
    (16, 2, 8, 1, 32, False), (24, 2, 8, 4, 6, True), (12, 1, 4, 2, 4, True)])
def test_unified_plan_with_peers_matches_jax(T, K, E, P, cap_send, skew):
    ids = _ids(T + E + P, T, K, E, skew)
    want = jdsp.make_unified_plan(jnp.asarray(ids), E, P, cap_send=cap_send,
                                  cap_expert=T)
    got = tdsp.make_unified_plan(torch.from_numpy(ids), E, P, cap_send=cap_send,
                                 cap_expert=T)
    for name in want._fields:
        _same(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("P,cap_send,skew", [(1, 32, False), (4, 8, True)])
def test_receiver_plans_match_jax(P, cap_send, skew):
    """eids_from_counts, recv_expert_plan and recv_ragged_plan on the
    counts a sender's plan produced."""
    T, K, E, bm = 16, 2, 8, 8
    ids = _ids(P * 7 + cap_send, T, K, E, skew)
    up = jdsp.make_unified_plan(jnp.asarray(ids), E, P, cap_send=cap_send)
    cnt = np.array(up.counts)
    e_local = E // P
    eid_j = jdsp.eids_from_counts(jnp.asarray(cnt), cap_send)
    eid_t = tdsp.eids_from_counts(torch.from_numpy(cnt), cap_send)
    _same(eid_t, eid_j)
    for cap in (P * T, 5):
        pj = jdsp.recv_expert_plan(jnp.asarray(cnt), eid_j, cap)
        pt = tdsp.recv_expert_plan(torch.from_numpy(cnt), eid_t, cap)
        for name in pj._fields:
            _same(getattr(pt, name), getattr(pj, name))
    for R in (-(-(P * cap_send + e_local * bm) // bm) * bm, 2 * bm):
        rj = jdsp.recv_ragged_plan(jnp.asarray(cnt), eid_j, R, bm)
        rt = tdsp.recv_ragged_plan(torch.from_numpy(cnt), eid_t, R, bm)
        for name in rj._fields:
            _same(getattr(rt, name), getattr(rj, name))


@pytest.mark.parametrize("seed,skew,rows", [(0, False, None), (1, True, None),
                                            (2, True, 40)])
def test_ragged_plan_and_invert_slots_match_jax(seed, skew, rows):
    T, K, E, bm = 24, 2, 4, 8
    ids = _ids(seed, T, K, E, skew)
    R = rows or -(-(T * K + E * bm) // bm) * bm
    valid = np.random.default_rng(seed).random((T, K)) < 0.8
    for v in (None, valid):
        pj = jdsp.make_ragged_plan(jnp.asarray(ids), E, R, bm,
                                   None if v is None else jnp.asarray(v))
        pt = tdsp.make_ragged_plan(torch.from_numpy(ids), E, R, bm,
                                   None if v is None else torch.from_numpy(v))
        for name in pj._fields:
            _same(getattr(pt, name), getattr(pj, name))
        _same(tdsp.invert_slots(pt.slots, R), jdsp.invert_slots(pj.slots, R))
    x = np.random.default_rng(seed).standard_normal((T, 8)).astype(np.float32)
    buf_t = tdsp.scatter_rows_flat(torch.from_numpy(x), pt.slots, R)
    buf_j = jdsp.scatter_rows_flat(jnp.asarray(x), pj.slots, R)
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    np.testing.assert_array_equal(
        tdsp.gather_rows_flat(buf_t, pt.slots).numpy(),
        np.asarray(jdsp.gather_rows_flat(buf_j, pj.slots)))
