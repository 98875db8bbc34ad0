"""The grouped expert-FFN CUDA kernels against their plain PyTorch versions.

Needs no JAX.  The tests marked ``cuda`` need an NVIDIA GPU and skip without
one; on the card run them with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine need not have).  The unmarked tests check the wrappers' argument
checks and CPU path, which hold on any machine.

Tolerances: fp32 1e-5 (the same products summed in another order, weights
at the model's init scale); bf16 1e-2 (both sides sum in fp32 and round once
to bf16, so they differ by at most one bf16 ulp, 2**-7 relative).
"""

import pytest
import torch

from repro_torch.kernels import grouped_mlp as gm
from repro_torch.kernels import ops, ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (E, M, K, N): M edges below, at and past the 64-row tile; N and K edges
# that are not tile multiples; a folded decode wave
SHAPES = [(2, 1, 64, 64), (3, 5, 40, 200), (2, 64, 96, 128),
          (2, 65, 128, 72), (4, 130, 256, 136), (8, 4, 512, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(E, M, K, N, n_weights, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((E, M, K), generator=g)
    ws = [torch.randn((E, K, N), generator=g) * K ** -0.5 for _ in range(n_weights)]
    return [t.to(device=device, dtype=dtype) for t in (x, *ws)]


def _assert_close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_swiglu_kernel_matches_plain(cuda, shape, dtype):
    x, w1, w3 = _inputs(*shape, 2, dtype, cuda)
    before = gm.grouped_swiglu.launches
    got = gm.grouped_swiglu(x, w1, w3)
    torch.cuda.synchronize()
    assert gm.grouped_swiglu.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[1], shape[3])
    _assert_close(got, ref.grouped_swiglu_ref(x, w1, w3), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_matmul_kernel_matches_plain(cuda, shape, dtype):
    x, w = _inputs(*shape, 1, dtype, cuda)
    before = gm.grouped_matmul.launches
    got = gm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gm.grouped_matmul.launches == before + 1
    _assert_close(got, ref.grouped_matmul_ref(x, w), dtype)


@pytest.mark.cuda
def test_expert_ffn_on_card_matches_plain(cuda):
    """Folded batch rows through both kernels, one launch each."""
    E, C, d, f = 4, 3, 128, 256
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((2, E, C, d), generator=g)
    w1, w3 = (torch.randn((E, d, f), generator=g) * d ** -0.5 for _ in range(2))
    w2 = torch.randn((E, f, d), generator=g) * f ** -0.5
    before = (gm.grouped_swiglu.launches, gm.grouped_matmul.launches)
    got = ops.expert_ffn(*(t.to(cuda) for t in (x, w1, w3, w2)))
    assert (gm.grouped_swiglu.launches, gm.grouped_matmul.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(got.cpu(), ref.expert_ffn_ref(x, w1, w3, w2), torch.float32)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w = _inputs(2, 4, 60, 64, 1, torch.float32, cuda)        # K % 8 != 0
    with pytest.raises(ValueError, match="multiples of 8"):
        gm.grouped_matmul(x, w)
    x, w = _inputs(2, 4, 64, 64, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)


# -- any machine ------------------------------------------------------------

def test_wrappers_check_shapes_and_types():
    x, w = _inputs(2, 4, 16, 8, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="does not match"):
        gm.grouped_matmul(x, w[:, :8])
    with pytest.raises(ValueError, match="dtype and device"):
        gm.grouped_matmul(x, w.double())
    with pytest.raises(ValueError, match="unsupported dtype"):
        gm.grouped_matmul(x.double(), w.double())
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        gm.grouped_swiglu(x[0], w[0], w[0])


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, w1, w3 = _inputs(2, 3, 16, 8, 2, torch.float32, "cpu")
    before = (gm.grouped_swiglu.launches, gm.grouped_matmul.launches)
    torch.testing.assert_close(gm.grouped_swiglu(x, w1, w3),
                               ref.grouped_swiglu_ref(x, w1, w3), rtol=0, atol=0)
    torch.testing.assert_close(gm.grouped_matmul(x, w1),
                               ref.grouped_matmul_ref(x, w1), rtol=0, atol=0)
    assert (gm.grouped_swiglu.launches, gm.grouped_matmul.launches) == before
