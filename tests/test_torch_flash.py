"""The port's flash attention (CPU path: its plain version) against the JAX
package's Pallas kernel in interpret mode, at 2e-5 as ``tests/test_kernels.py``
holds the JAX kernel: causal, a sliding window of 16, ``causal=False`` with
Skv != S, and the JAX kernel at three block shapes.  Inputs from numpy with
a seed, in the JAX layout (heads folded into the leading dim)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as t_flash  # noqa: E402

torch.set_num_threads(min(torch.get_num_threads(), 2))
TOL = 2e-5


def _qkv(BH, S, Skv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, S, hd)).astype(np.float32),
            rng.standard_normal((BH, Skv, hd)).astype(np.float32),
            rng.standard_normal((BH, Skv, hd)).astype(np.float32))


@pytest.mark.parametrize("mode,S,Skv,kwargs", [
    ("causal", 64, 64, dict(causal=True)),
    ("window", 64, 64, dict(causal=True, window=16)),
    ("cross", 48, 64, dict(causal=False)),
    ("cross-window", 48, 64, dict(causal=False, window=16)),
    ("causal-shorter-kv", 64, 32, dict(causal=True)),
])
def test_flash_attention_matches_pallas(mode, S, Skv, kwargs):
    q, k, v = _qkv(8, S, Skv, 16, seed=len(mode))
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), interpret=True,
                   block_q=16, block_kv=16, **kwargs)
    got = t_flash(*(torch.from_numpy(a) for a in (q, k, v)), **kwargs)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bq,bk", [(8, 32), (64, 8), (64, 64)])
def test_flash_attention_matches_pallas_at_every_block_shape(bq, bk):
    """The JAX kernel visits other tiles at each block shape (a wholly
    masked KV block is skipped); the function is the same."""
    q, k, v = _qkv(2, 64, 64, 8, seed=bq + bk)
    got = t_flash(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=24)
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=24,
                   interpret=True, block_q=bq, block_kv=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_attention_mask_and_rows_that_see_no_key():
    """The mask is the JAX kernel's; rows with no visible key (only with a
    window and S >= Skv + window) are refused, not given a value that
    depends on a block shape."""
    m = ref.attention_mask(6, 6, causal=True, window=2).int().tolist()
    assert m == [[1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0], [0, 1, 1, 0, 0, 0],
                 [0, 0, 1, 1, 0, 0], [0, 0, 0, 1, 1, 0], [0, 0, 0, 0, 1, 1]]
    assert ref.attention_mask(3, 5, causal=False, window=0).all()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 40, 16, 8, seed=0))
    with pytest.raises(ValueError, match="see no key"):
        t_flash(q, k, v, causal=False, window=24)
    t_flash(q[:, :39], k, v, causal=False, window=24)       # the last row sees key 15
    with pytest.raises(ValueError, match="expected"):
        t_flash(q, k[:, :, :4], v, causal=True)


def test_plain_version_is_one_masked_softmax():
    """The plain version is softmax over the masked scores, then P·V."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 40, 40, 8, seed=3))
    s = (q @ k.transpose(1, 2)) * 8 ** -0.5
    s = torch.where(ref.attention_mask(40, 40, True, 0), s, ref.NEG_INF)
    want = torch.softmax(s, dim=-1) @ v
    torch.testing.assert_close(ref.flash_attention_ref(q, k, v, causal=True), want,
                               rtol=1e-5, atol=1e-5)
