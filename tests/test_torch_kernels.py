"""The port's grouped expert-FFN wrappers on CPU tensors against the JAX
package's Pallas kernels run in interpret mode.

Same inputs from a seeded numpy generator into both, the weights at the
model's init scale K**-0.5; fp32, so the only difference is the order of the
fp32 sums: rtol = atol = 1e-5."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import grouped_mlp as jgm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import grouped_mlp as tgm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# (E, M, K, N): a folded decode wave, a prefill chunk, ragged M/N edges
SHAPES = [(4, 4, 256, 512), (4, 16, 512, 256), (3, 5, 64, 40)]


def _arrays(seed, x_shape, *w_shapes):
    """x at unit scale, each weight (..., K, N) at K**-0.5."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(x_shape).astype(np.float32)] + [
        (rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
        for s in w_shapes]


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_swiglu_matches_jax_interpret(shape):
    E, M, K, N = shape
    x, w1, w3 = _arrays(0, (E, M, K), (E, K, N), (E, K, N))
    want = jgm.grouped_swiglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                              interpret=True, block_m=32, block_n=32, block_k=32)
    got = tgm.grouped_swiglu(_t(x), _t(w1), _t(w3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_matmul_matches_jax_interpret(shape):
    E, M, K, N = shape
    x, w = _arrays(1, (E, M, K), (E, K, N))
    want = jgm.grouped_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True,
                              block_m=32, block_n=32, block_k=32)
    got = tgm.grouped_matmul(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_expert_ffn_folds_batch_rows(lead):
    """The port folds leading batch dims into M (one launch); the JAX
    package vmaps one launch per row.  Same function."""
    E, C, d, f = 4, 6, 64, 128
    x, w1, w3, w2 = _arrays(2, lead + (E, C, d), (E, d, f), (E, d, f), (E, f, d))
    want = jops.expert_ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3),
                           jnp.asarray(w2), use_pallas=True, interpret=True)
    got = tops.expert_ffn(_t(x), _t(w1), _t(w3), _t(w2))
    assert got.shape == lead + (E, C, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
