"""The port's Mamba-2 (SSD) mixer (``repro_torch/models/ssm.py``) against
the JAX package's ``repro/models/ssm.py``, in fp32.

The same seeded numpy inputs and the JAX init's weights (carried as numpy)
go through both: ``ssd_scan`` with and without an initial state and at a
length that pads its last chunk, ``apply_ssm`` with its final state and
from a prefix's state, and ``decode_ssm``.  Then the reference's own SSD
properties (``tests/test_models.py``), on the port: chunk invariance,
decode continuing from a prefill's state, and SSD against the token-by-
token recurrence.

Tolerance: rtol = atol = 1e-4 for every float (the port's ``TOL``: fp32
products summed in another order by another framework)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import SSMSpec as JSpec  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SPEC = SSMSpec(state_dim=16, head_dim=8, expand=2, conv_width=4, chunk=8)
JSPEC = JSpec(state_dim=16, head_dim=8, expand=2, conv_width=4, chunk=8)
D = 32


# jitted: op by op, the reference's SSD dispatches hundreds of small ops
_j_ssd = jax.jit(jssm.ssd_scan, static_argnums=5)
_j_apply = jax.jit(jssm.apply_ssm, static_argnums=(2, 3))
_j_decode = jax.jit(jssm.decode_ssm, static_argnums=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(d=D, seed=0):
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), d, JSPEC)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jp, tp


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_matches_the_reference_shapes_and_constants():
    jp, _ = _params()
    normal = _Normal()
    tp = ssm.init_ssm(normal, D, SPEC)
    assert set(tp) == set(jp)
    for k in jp:
        want = jp[k]["scale"] if k == "norm" else jp[k]
        got = tp[k]["scale"] if k == "norm" else tp[k]
        assert tuple(got.shape) == tuple(want.shape), k
        assert str(got.dtype).split(".")[-1] == str(want.dtype), k
    for k in ("A_log", "D", "dt_bias", "conv_b"):
        _close(tp[k], jp[k])


class _Normal:
    device, dtype = torch.device("cpu"), torch.float32

    def __call__(self, shape, scale):
        return torch.randn(shape, generator=torch.Generator().manual_seed(0)) * scale


@pytest.mark.parametrize("T,chunk,with_state", [(16, 8, False), (13, 8, False),
                                                (21, 8, True), (8, 8, True)])
def test_ssd_scan_matches_the_reference(T, chunk, with_state):
    rng = np.random.default_rng(T)
    b, H, P, N = 2, 4, 8, 16
    x = rng.standard_normal((b, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, T, H)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    B = rng.standard_normal((b, T, N)).astype(np.float32)
    C = rng.standard_normal((b, T, N)).astype(np.float32)
    s0 = rng.standard_normal((b, H, P, N)).astype(np.float32) if with_state else None
    jy, js = _j_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk,
                    None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.ssd_scan(*(_t(a) for a in (x, dt, A, B, C)), chunk,
                          None if s0 is None else _t(s0))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("T", [12, 3])
def test_apply_ssm_and_its_state_match_the_reference(T):
    jp, tp = _params()
    x = np.random.default_rng(T).standard_normal((2, T, D)).astype(np.float32) * 0.5
    jy, jst = _j_apply(jp, jnp.asarray(x), JSPEC, True)
    ty, tst = ssm.apply_ssm(tp, _t(x), SPEC, return_state=True)
    _close(ty, jy)
    _close(tst["ssm"], jst.ssm)
    _close(tst["conv"], jst.conv)
    # continue from that state: a chunk extension
    x2 = np.random.default_rng(T + 1).standard_normal((2, 5, D)).astype(np.float32)
    jy2, jst2 = _j_apply(jp, jnp.asarray(x2), JSPEC, True, jst)
    ty2, tst2 = ssm.apply_ssm(tp, _t(x2), SPEC, return_state=True,
                              initial_state=tst)
    _close(ty2, jy2)
    _close(tst2["ssm"], jst2.ssm)
    _close(tst2["conv"], jst2.conv)
    # and one decode step from it
    x3 = np.random.default_rng(T + 2).standard_normal((2, 1, D)).astype(np.float32)
    jy3, jst3 = _j_decode(jp, jnp.asarray(x3), jst2, JSPEC)
    ty3, tst3 = ssm.decode_ssm(tp, _t(x3), tst2, SPEC)
    _close(ty3, jy3)
    _close(tst3["ssm"], jst3.ssm)
    _close(tst3["conv"], jst3.conv)


# -- the reference's SSD properties (tests/test_models.py), on the port ------

def _x(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32) * 0.5)


def test_ssd_chunk_invariance():
    _, tp = _params()
    x = _x(1, (2, 32, D))
    y1 = ssm.apply_ssm(tp, x, SPEC)
    y2 = ssm.apply_ssm(tp, x, dataclasses.replace(SPEC, chunk=16))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)


def test_ssd_decode_consistency():
    _, tp = _params()
    x = _x(1, (2, 33, D))
    y_full, st_full = ssm.apply_ssm(tp, x, SPEC, return_state=True)
    _, st = ssm.apply_ssm(tp, x[:, :-1], SPEC, return_state=True)
    y_dec, st2 = ssm.decode_ssm(tp, x[:, -1:], st, SPEC)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, -1].numpy(), atol=1e-4)
    np.testing.assert_allclose(st2["ssm"].numpy(), st_full["ssm"].numpy(), atol=1e-4)
    np.testing.assert_allclose(st2["conv"].numpy(), st_full["conv"].numpy(), atol=1e-6)


def test_ssd_matches_naive_recurrence():
    _, tp = _params(d=16)
    x = _x(2, (1, 12, 16))
    y_ssd = ssm.apply_ssm(tp, x, SPEC)
    state = ssm.init_state(1, 16, SPEC, x.dtype, x.device)
    ys = []
    for t in range(12):
        yt, state = ssm.decode_ssm(tp, x[:, t:t + 1], state, SPEC)
        ys.append(yt)
    np.testing.assert_allclose(y_ssd.numpy(), torch.cat(ys, 1).numpy(), atol=1e-4)


def test_decode_keeps_an_fp32_state_under_bf16_weights():
    """bf16 weights over an fp32 state, as the serving cache holds it: 32
    decode steps against the reference's, which promotes the recurrence to
    fp32.  The state holds at ``TOL`` (one bf16 rounding of it a step is
    ~1e-3 off); the output, which the port casts back to bf16 where the
    reference keeps fp32, within 2**-6 (bf16 keeps 8 bits)."""
    jp = jssm.init_ssm(jax.random.PRNGKey(0), D, JSPEC, jnp.bfloat16)
    tp = jax.tree.map(lambda a: _t(np.asarray(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), jp)
    B = 2
    js = jssm.init_state(B, D, JSPEC, jnp.float32)
    ts = ssm.init_state(B, D, SPEC, torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(5)
    for _ in range(32):
        x = rng.standard_normal((B, 1, D)).astype(np.float32)
        jy, js = _j_decode(jp, jnp.asarray(x, jnp.bfloat16), js, JSPEC)
        ty, ts = ssm.decode_ssm(tp, _t(x).to(torch.bfloat16), ts, SPEC)
        assert ty.dtype == torch.bfloat16 and ts["ssm"].dtype == torch.float32
        _close(ts["ssm"], js.ssm)
        _close(ts["conv"], js.conv)
        np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                                   rtol=2 ** -6, atol=2 ** -6)
