"""The port's CUDA kernels against their plain PyTorch versions.

Needs no JAX.  The tests marked ``cuda`` need an NVIDIA GPU and skip without
one; on the card run them with

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine need not have).  The unmarked tests check the wrappers' argument
checks and CPU path, which hold on any machine.

Tolerances: fp32 1e-5 (the same products summed in another order, weights
at the model's init scale); bf16 1e-2 (both sides sum in fp32 and round once
to bf16, so they differ by at most one bf16 ulp, 2**-7 relative).  The
dispatch kernels move and scale rows with the plain version's rounding
points, so they are held to equality.  Flash attention: fp32 2e-5, the
tolerance the JAX package holds its own kernel to; bf16 1e-2 (the kernel
rounds P to bf16 for P·V, 2**-9 relative per weight, and the output once).
The serving engine's CUDA graphs replay the eager step's kernels in its
order on its shapes, so they are held to equality with the eager step.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import dispatch as dsp
from repro_torch.core.moe import DistContext
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels import dispatch_cuda as dc
from repro_torch.kernels import grouped_mlp as gm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_moe import fused_moe
from repro_torch.kernels.ragged_mlp import ragged_matmul, ragged_swiglu
from repro_torch.kernels.weight_grad import segment_outer
from repro_torch.models import transformer
from repro_torch.serving import engine
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler, Request,
                                           ServeConfig)

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


def _exact(shape, g):
    """Small integers: bf16 holds them, and with ``_exact_weights`` every
    fp32 product and sum over the tests' K is exact."""
    return torch.randint(-4, 5, shape, generator=g).float()


def _exact_weights(shape, g):
    """0 and +-2^-k, k < 4."""
    return (2.0 ** -torch.randint(0, 4, shape, generator=g).float()
            * torch.randint(-1, 2, shape, generator=g).float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_grouped_matmul_bf16_is_exact_under_exact_arithmetic(cuda, shape):
    """Integer rows and power-of-two weights: the Hopper kernel's fp32 sums
    are exact, so it equals the plain version bit for bit at every M, N and
    K edge."""
    E, M, K, N = shape
    g = torch.Generator(device="cpu").manual_seed(M * K + N)
    x = _exact((E, M, K), g).to(cuda, torch.bfloat16)
    w = _exact_weights((E, K, N), g).to(cuda, torch.bfloat16)
    torch.testing.assert_close(gm.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 64])
def test_grouped_matmul_bf16_is_deterministic_at_large_k(cuda, M):
    """Mixtral-8x7B's down-projection at a decode wave (M 4) and at a full
    64-row tile: a pipeline fault (a stage overwritten before its products
    are done) shows as rare mismatches, so 8 relaunches must equal the first
    bit for bit, and the plain version to tolerance."""
    E, K, N = 8, 14336, 4096
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((E, M, K), generator=g, device=cuda).bfloat16()
    w = (torch.randn((E, K, N), generator=g, device=cuda) * K ** -0.5).bfloat16()
    first = gm.grouped_matmul(x, w)
    for _ in range(8):
        torch.testing.assert_close(gm.grouped_matmul(x, w), first, rtol=0, atol=0)
    _assert_close(first, ref.grouped_matmul_ref(x, w), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 64])
def test_grouped_swiglu_bf16_is_deterministic_at_large_k(cuda, M):
    """Mixtral-8x7B's up-projections at a decode wave (M 4) and at a full
    64-row tile: two weights share each stage of the ring, so a stage
    released early would corrupt either product; 8 relaunches must equal
    the first bit for bit, and the plain version to tolerance."""
    E, K, N = 8, 4096, 14336
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((E, M, K), generator=g, device=cuda).bfloat16()
    w1, w3 = ((torch.randn((E, K, N), generator=g, device=cuda) * K ** -0.5).bfloat16()
              for _ in range(2))
    first = gm.grouped_swiglu(x, w1, w3)
    for _ in range(8):
        torch.testing.assert_close(gm.grouped_swiglu(x, w1, w3), first, rtol=0, atol=0)
    _assert_close(first, ref.grouped_swiglu_ref(x, w1, w3), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("n_weights", [1, 2])
@pytest.mark.parametrize("E,M,N", [(1, 1, 200), (1, 65, 200), (1, 130, 72), (2, 70, 136)])
def test_grouped_bf16_stores_nothing_past_m_or_n(cuda, E, M, N, n_weights):
    """The weight stream computes whole 64-row x 128-column tiles, and the
    rows past M and columns past N of a tile must never be stored.  The
    kernel writes into a buffer longer than (E, M, N), filled with a
    sentinel: the last expert's rows past M and the columns past N of its
    last row would land in the tail, which must keep the sentinel (with M 1
    every column past N would); the head must hold the plain result."""
    K = 96
    x, *ws = _inputs(E, M, K, N, n_weights, torch.bfloat16, cuda)
    op = "grouped_swiglu" if n_weights == 2 else "grouped_matmul"
    plain = ref.grouped_swiglu_ref if n_weights == 2 else ref.grouped_matmul_ref
    tail = 128 * 256
    buf = torch.full((E * M * N + tail,), 7.0, dtype=torch.bfloat16, device=cuda)
    _cuda.launch("grouped_mlp", f"{op}_bf16", [x, *ws, buf, E, M, K, N], cuda)
    torch.cuda.synchronize()
    assert bool((buf[E * M * N:] == 7.0).all())
    _assert_close(buf[:E * M * N].view(E, M, N), plain(x, *ws), torch.bfloat16)


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


@pytest.mark.cuda
def test_grouped_kernels_refuse_autograd(cuda):
    """On the card the grouped kernels have no backward: under autograd on
    operands that require grad they raise instead of dropping the path."""
    x, w = _inputs(2, 4, 64, 64, 1, torch.float32, cuda)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused expert leg"):
        gm.grouped_matmul(x, w)
    with torch.no_grad():
        gm.grouped_matmul(x, w)                # serving: no autograd, fine


def _ragged_case(T, K, E, d, f, bm, dtype, device, seed=0, skew=False, dead=0):
    """A routed ragged layout (the receiver's plan) with tokens, weights at
    the model's init scale and per-row combine weights; ``dead`` more row
    blocks past the ones routing can fill."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if skew:
        ids = torch.where(torch.rand((T, K), generator=g) < 0.7, 0,
                          torch.randint(0, E, (T, K), generator=g))
        ids[:, 1:] = (ids[:, :1] + 1 + ids[:, 1:] % (E - 1)) % E if K > 1 else ids[:, 1:]
    else:
        ids = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
    R = (-(-(T * K + E * bm) // bm) + dead) * bm
    plan = dsp.make_ragged_plan(ids.to(torch.int32), E, R, bm)
    pos = dsp.invert_slots(plan.slots, R)
    src = torch.where(pos >= 0, pos // K, -1).to(torch.int32)
    wtk = torch.rand((T, K), generator=g)
    wslot = torch.where(pos >= 0, wtk.reshape(-1)[pos.clamp_min(0).long()], 0.0)
    x = torch.randn((T, d), generator=g)
    w1, w3 = (torch.randn((E, d, f), generator=g) * d ** -0.5 for _ in range(2))
    w2 = torch.randn((E, f, d), generator=g) * f ** -0.5
    floats = [t.to(device=device, dtype=dtype) for t in (x, w1, w3, w2, wslot, wtk)]
    ints = [t.to(device) for t in (plan.slots, plan.block_to_expert,
                                   plan.total_rows, src)]
    return floats, ints, R


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,d", [(24, 2, 16), (64, 1, 256), (33, 2, 72)])
def test_dispatch_kernels_match_plain(cuda, T, K, d, dtype):
    (x, _, _, _, wslot, wtk), (slots, _, total, src), R = _ragged_case(
        T, K, 4, d, 8, 8, dtype, cuda)
    before = (dc.scatter_rows.launches, dc.gather_combine.launches)
    for w in (None, wslot):
        buf = dc.scatter_rows(x, src, total, w)
        torch.testing.assert_close(buf, ref.scatter_rows_ref(x, src, total, w),
                                   rtol=0, atol=0)
    for w in (None, wtk):
        torch.testing.assert_close(dc.gather_combine(buf, slots, w),
                                   ref.gather_combine_ref(buf, slots, w),
                                   rtol=0, atol=0)
    torch.cuda.synchronize()
    assert (dc.scatter_rows.launches, dc.gather_combine.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4096, 4104, 72])
def test_scatter_rows_is_bit_equal_with_dead_rows_and_weights(cuda, d, dtype):
    """scatter_rows at the model's width (whole rounds of a warp's 256
    vectors), at a width that leaves a partial round (4104) and at one of
    fewer vectors than a warp has lanes (72): rows with src = -1 inside the
    live prefix and rows past total_rows (with valid sources, which must not
    be read) are 0, and live rows equal the plain version bit for bit, with
    and without slot weights, with total_rows as an int (passed by value)
    or a device tensor."""
    g = torch.Generator(device="cpu").manual_seed(d)
    T, R, total = 300, 644, 515
    x = torch.randn((T, d), generator=g).to(cuda, dtype)
    src = torch.randint(0, T, (R,), generator=g, dtype=torch.int32)
    src[torch.rand(R, generator=g) < 0.1] = -1
    src = src.to(cuda)
    w = torch.rand(R, generator=g).to(cuda, dtype)
    for weights in (None, w):
        for rows in (total, torch.tensor(total, device=cuda)):
            got = dc.scatter_rows(x, src, rows, weights)
            want = ref.scatter_rows_ref(x, src, total, weights)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            assert not got[total:].any() and not got[:total][src[:total] < 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,E,d,f,bm,skew", [(24, 2, 4, 16, 32, 8, False),
                                               (96, 2, 4, 64, 136, 64, True),
                                               (200, 2, 8, 128, 256, 128, True)])
def test_ragged_and_fused_kernels_match_plain(cuda, T, K, E, d, f, bm, skew, dtype):
    (x, w1, w3, w2, wslot, _), (slots, b2e, total, src), R = _ragged_case(
        T, K, E, d, f, bm, dtype, cuda, seed=T, skew=skew)
    buf = ref.scatter_rows_ref(x, src, total)
    before = (ragged_matmul.launches, fused_moe.launches)
    for w, a, trans in ((w1, buf, False), (w2, buf, True)):
        got = ragged_matmul(a, w, b2e, total, bm, transpose_w=trans)
        want = ref.ragged_matmul_ref(a, w.transpose(1, 2) if trans else w, b2e, total)
        _assert_close(got, want, dtype)
        assert (got[int(total):] == 0).all()
    for w in (None, wslot):
        got = fused_moe(x, w1, w3, w2, src, w, total, b2e)
        want = ref.fused_moe_rows_ref(x, w1, w3, w2, src, w, b2e, total)
        assert got.dtype == dtype and got.shape == x.shape
        _assert_close(got, want, dtype)
    torch.cuda.synchronize()
    assert (ragged_matmul.launches, fused_moe.launches) == (before[0] + 2, before[1] + 2)


def _blocked_case(nb, live_blocks, E, K, N, bm, trans, seed, exact=False):
    """x (nb * bm, K) in row blocks of ascending experts, the first
    ``live_blocks`` live; w (E, K, N), or (E, N, K) when ``trans``.  exact:
    small integers and power-of-two weights, so every fp32 sum is exact."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b2e = torch.sort(torch.randint(0, E, (nb,), generator=g)).values.to(torch.int32)
    wshape = (E, N, K) if trans else (E, K, N)
    if exact:
        x, w = _exact((nb * bm, K), g), _exact_weights(wshape, g)
    else:
        x = torch.randn((nb * bm, K), generator=g)
        w = torch.randn(wshape, generator=g) * K ** -0.5
    return x, w, b2e, torch.tensor(live_blocks * bm, dtype=torch.int32)


# (row blocks, live blocks, E, K, N, bm): several 256-column tiles with N off
# the tile, K off the 64-deep k-block, dead row blocks, 64- and 8-row tiles
RAGGED_BF16_CASES = [(6, 4, 4, 136, 600, 128), (5, 5, 3, 64, 200, 128),
                     (3, 1, 2, 4096, 256, 128), (7, 5, 4, 136, 200, 64),
                     (12, 9, 4, 72, 136, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nb,live,E,K,N,bm", RAGGED_BF16_CASES)
def test_ragged_matmul_bf16_kernel_matches_plain(cuda, nb, live, E, K, N, bm, trans):
    """The bf16 Hopper kernel against the plain version, N-major and K-major
    weights; rows past total_rows exactly 0."""
    x, w, b2e, total = (t.to(cuda) for t in _blocked_case(nb, live, E, K, N, bm, trans,
                                                          seed=nb * K + N))
    x, w = x.bfloat16(), w.bfloat16()
    before = ragged_matmul.launches
    got = ragged_matmul(x, w, b2e, total, bm, transpose_w=trans)
    torch.cuda.synchronize()
    assert ragged_matmul.launches == before + 1
    want = ref.ragged_matmul_ref(x, w.transpose(1, 2) if trans else w, b2e, total)
    _assert_close(got, want, torch.bfloat16)
    assert (got[int(total):] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("bm", [128, 64, 8])
def test_ragged_matmul_bf16_is_exact_under_exact_arithmetic(cuda, bm, trans):
    """Integer rows and power-of-two weights: every product and fp32 sum is
    exact, so the kernel equals the plain version bit for bit."""
    nb = max(4, 512 // bm)
    x, w, b2e, total = (t.to(cuda) for t in _blocked_case(nb, nb - 1, 4, 1000, 328, bm,
                                                          trans, seed=bm, exact=True))
    x, w = x.bfloat16(), w.bfloat16()
    got = ragged_matmul(x, w, b2e, total, bm, transpose_w=trans)
    want = ref.ragged_matmul_ref(x, w.transpose(1, 2) if trans else w, b2e, total)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
def test_ragged_matmul_bf16_is_deterministic_at_large_k(cuda, trans):
    """A pipeline fault (a stage overwritten before its products are done)
    shows as rare mismatches at large K: repeated launches must agree bit
    for bit, and with the plain version."""
    x, w, b2e, total = (t.to(cuda) for t in _blocked_case(12, 11, 4, 8192, 512, 128, trans,
                                                          seed=5))
    x, w = x.bfloat16(), w.bfloat16()
    first = ragged_matmul(x, w, b2e, total, 128, transpose_w=trans)
    for _ in range(4):
        torch.testing.assert_close(ragged_matmul(x, w, b2e, total, 128, transpose_w=trans),
                                   first, rtol=0, atol=0)
    want = ref.ragged_matmul_ref(x, w.transpose(1, 2) if trans else w, b2e, total)
    _assert_close(first, want, torch.bfloat16)


@pytest.mark.cuda
def test_moe_ffn_on_card_matches_cpu(cuda):
    """The fused leg's forward and gradients on the card's kernels against
    the same Functions on the CPU's plain versions, fp32."""
    (x, w1, w3, w2, _, wtk), (slots, b2e, total, _), _ = _ragged_case(
        48, 2, 4, 64, 128, 8, torch.float32, "cpu", skew=True)
    outs = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, w1, w3, w2, wtk)]
        y = ops.moe_ffn(*leaves[:4], slots.to(dev), b2e.to(dev), total.to(dev),
                        leaves[4], block_m=8)
        (y.float() ** 2).sum().backward()
        outs[str(dev)] = [y.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (T, K, E, d, f, bm): 8-, 64- and 128-row blocks; d off the 64-deep k-block
# (the gathered rows' K tail) and f off the 128-column up tile, the down
# tile's columns past d; two slots per token, or one as on the EP path
FUSED_BF16_CASES = [(40, 2, 4, 72, 200, 8), (150, 2, 4, 136, 264, 64),
                    (300, 2, 8, 200, 328, 128), (256, 1, 8, 256, 384, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,K,E,d,f,bm", FUSED_BF16_CASES)
def test_fused_moe_bf16_kernel_matches_plain(cuda, T, K, E, d, f, bm):
    """The bf16 Hopper passes (rows gathered by cp.async, the combine as the
    down pass's epilogue) against the plain version under skewed routing,
    with dead row blocks past the routed ones."""
    (x, w1, w3, w2, wslot, _), (_, b2e, total, src), R = _ragged_case(
        T, K, E, d, f, bm, torch.bfloat16, cuda, seed=T + d, skew=True, dead=3)
    assert int(total) < R - 2 * bm
    before = fused_moe.launches
    for w in (None, wslot):
        got = fused_moe(x, w1, w3, w2, src, w, total, b2e)
        want = ref.fused_moe_rows_ref(x, w1, w3, w2, src, w, b2e, total)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        _assert_close(got, want, torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_moe.launches == before + 2


@pytest.mark.cuda
def test_fused_moe_bf16_is_deterministic_with_one_slot_per_token(cuda):
    """With a (T, 1) slot map, as on the EP path, each output row is 0 plus
    one fp32 term, so the atomic combine is order-free: 8 relaunches must
    equal the first bit for bit."""
    (x, w1, w3, w2, wslot, _), (_, b2e, total, src), _ = _ragged_case(
        512, 1, 8, 512, 1024, 128, torch.bfloat16, cuda, seed=7, skew=True, dead=2)
    first = fused_moe(x, w1, w3, w2, src, wslot, total, b2e)
    for _ in range(8):
        torch.testing.assert_close(fused_moe(x, w1, w3, w2, src, wslot, total, b2e),
                                   first, rtol=0, atol=0)
    _assert_close(first, ref.fused_moe_rows_ref(x, w1, w3, w2, src, wslot, b2e, total),
                  torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,E,d,f,bm,skew", [(24, 2, 4, 16, 32, 8, False),
                                               (96, 2, 4, 64, 136, 64, True),
                                               (200, 2, 8, 128, 256, 128, True)])
def test_ragged_swiglu_kernel_matches_plain(cuda, T, K, E, d, f, bm, skew, dtype):
    (x, w1, w3, _, _, _), (_, b2e, total, src), R = _ragged_case(
        T, K, E, d, f, bm, dtype, cuda, seed=T + 1, skew=skew)
    buf = ref.scatter_rows_ref(x, src, total)
    before = ragged_swiglu.launches
    got = ragged_swiglu(buf, w1, w3, b2e, total, bm)
    torch.cuda.synchronize()
    assert ragged_swiglu.launches == before + 1
    assert got.dtype == dtype and got.shape == (R, f)
    _assert_close(got, ref.ragged_swiglu_ref(buf, w1, w3, b2e, total), dtype)
    assert (got[int(total):] == 0).all()


@pytest.mark.cuda
def test_ragged_expert_ffn_on_card_matches_cpu(cuda):
    """The ragged leg's FFN forward and gradients on the card's kernels
    against the same Function on the CPU's plain versions, fp32."""
    (x, w1, w3, w2, _, _), (_, b2e, total, src), _ = _ragged_case(
        48, 2, 4, 64, 128, 8, torch.float32, "cpu", skew=True)
    buf = ref.scatter_rows_ref(x, src, total)
    outs = {}
    for dev in ("cpu", cuda):
        before = ragged_swiglu.launches
        leaves = [t.detach().to(dev).requires_grad_() for t in (buf, w1, w3, w2)]
        y = ops.ragged_expert_ffn(*leaves, b2e.to(dev), total.to(dev), block_m=8)
        (y ** 2).sum().backward()
        assert ragged_swiglu.launches == before + (dev != "cpu")
        outs[str(dev)] = [y.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# (row blocks, live blocks, E, K, N, bm): 8-, 16-, 64- and 128-row blocks;
# N off the 128-column and 256-column tiles, K off the 64- and 128-row tiles,
# dead row blocks past the live ones
SWIGLU_BF16_CASES = [(12, 9, 4, 72, 136, 8), (7, 5, 4, 136, 200, 64),
                     (6, 4, 4, 136, 600, 128), (3, 1, 2, 4096, 256, 128),
                     (5, 5, 3, 64, 328, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,live,E,K,N,bm", SWIGLU_BF16_CASES)
def test_ragged_swiglu_bf16_kernel_matches_plain(cuda, nb, live, E, K, N, bm):
    """The bf16 Hopper route (the shared mainloop with two weights) against
    the plain version, with R a partial 128-row tile at bm 64 and dead rows
    exactly 0."""
    x, w1, b2e, total = (t.to(cuda) for t in _blocked_case(nb, live, E, K, N, bm, False,
                                                           seed=nb + K + N))
    g = torch.Generator(device="cpu").manual_seed(N)
    w3 = (torch.randn(w1.shape, generator=g) * K ** -0.5).to(cuda)
    x, w1, w3 = x.bfloat16(), w1.bfloat16(), w3.bfloat16()
    before = ragged_swiglu.launches
    got = ragged_swiglu(x, w1, w3, b2e, total, bm)
    torch.cuda.synchronize()
    assert ragged_swiglu.launches == before + 1
    _assert_close(got, ref.ragged_swiglu_ref(x, w1, w3, b2e, total), torch.bfloat16)
    assert (got[int(total):] == 0).all()


@pytest.mark.cuda
def test_ragged_swiglu_bf16_is_deterministic_at_large_k(cuda):
    """8 relaunches equal the first bit for bit (a stage released before
    its products are done shows as rare mismatches)."""
    x, w1, b2e, total = (t.to(cuda) for t in _blocked_case(12, 11, 4, 4096, 512, 128,
                                                           False, seed=11))
    w3 = torch.flip(w1, dims=(2,)).contiguous()
    x, w1, w3 = x.bfloat16(), w1.bfloat16(), w3.bfloat16()
    first = ragged_swiglu(x, w1, w3, b2e, total, 128)
    for _ in range(8):
        torch.testing.assert_close(ragged_swiglu(x, w1, w3, b2e, total, 128), first,
                                   rtol=0, atol=0)
    _assert_close(first, ref.ragged_swiglu_ref(x, w1, w3, b2e, total), torch.bfloat16)


def _wgrad_case(nb, live, E, K, N, bm, seed, exact=False, empty=(), device="cpu"):
    """a (nb * bm, K), b (nb * bm, N) in row blocks of ascending experts
    (none of ``empty``), the first ``live`` blocks live and the rest holding
    nonzero rows the kernel must skip.  exact: small integers, so every fp32
    sum is exact."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    experts = torch.tensor([e for e in range(E) if e not in empty])
    b2e = torch.sort(experts[torch.randint(0, len(experts), (nb,), generator=g)]).values
    if exact:
        a, b = (_exact((nb * bm, n), g) for n in (K, N))
    else:
        a, b = (torch.randn((nb * bm, n), generator=g) for n in (K, N))
    old = torch.randn((E, K, N), generator=g)
    total = torch.tensor(live * bm, dtype=torch.int32)
    return [t.to(device) for t in (a, b, b2e.to(torch.int32), total, old)]


# (row blocks, live blocks, E, K, N, bm, experts with no rows): first one
# output tile of one expert (the M-major A operand alone; K 64 takes 64-row
# output tiles, K > 64 128-row ones), then K and N off their tiles, dead
# blocks, 8- and 16-row blocks (8-row groups, a half k16 step padded), and
# experts with no rows
WGRAD_CASES = [(1, 1, 1, 64, 256, 64, ()), (1, 1, 1, 128, 256, 64, ()),
               (6, 4, 4, 136, 600, 128, ()), (7, 5, 4, 72, 200, 64, ()),
               (13, 9, 4, 64, 136, 8, ()), (10, 8, 4, 200, 264, 16, (2,)),
               (5, 5, 3, 256, 512, 128, (1,)), (9, 7, 4, 64, 264, 64, (0, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("nb,live,E,K,N,bm,empty", WGRAD_CASES)
def test_segment_outer_bf16_is_exact_under_exact_arithmetic(cuda, nb, live, E, K, N, bm,
                                                            empty, accumulate):
    """Integer rows: every fp32 sum is exact, so the kernel's write and add
    equal the plain version bit for bit, and an expert with no rows gets 0
    (write) or keeps its old values (add)."""
    a, b, b2e, total, old = _wgrad_case(nb, live, E, K, N, bm, seed=nb * K + N, exact=True,
                                        empty=empty, device=cuda)
    a, b, old = a.bfloat16(), b.bfloat16(), old.bfloat16()
    before = segment_outer.launches
    got = segment_outer(a, b, b2e, total, bm, old.clone(), accumulate=accumulate)
    torch.cuda.synchronize()
    assert segment_outer.launches == before + 1
    want = ref.segment_outer_ref(a, b, b2e, total, old.clone(), accumulate)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for e in empty:
        assert torch.equal(got[e], old[e] if accumulate else torch.zeros_like(old[e]))


def _assert_wgrad_close(got, want, a, b, b2e, total, accumulate):
    """The weight gradient against its plain version when both sum the same
    products in fp32 in other orders.  fp32: to 1e-5 of the largest
    magnitude (a sum of n Gaussian products drifts by ~sqrt(n) eps of its
    terms, however small the sum).  bf16: the file's one-ulp tolerance,
    1e-2 absolute and relative; adding into the buffer rounds the sum to
    bf16 before the add, so when adding the sum's own ulp (1e-2 of |sum|)
    comes on top, which shows where the add cancels."""
    if got.dtype == torch.float32:
        tol = 1e-5 * want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        return
    tol = TOL[torch.bfloat16]
    bound = tol + tol * want.float().abs()
    if accumulate:
        s = ref.segment_outer_ref(a, b, b2e, total, torch.empty_like(want), False)
        bound += tol * s.float().abs()
    err = (got.float() - want.float()).abs()
    assert (err <= bound).all(), f"{int((err > bound).sum())} elements past the tolerance"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("nb,live,E,K,N,bm,empty", WGRAD_CASES[2:])
def test_segment_outer_kernel_matches_plain(cuda, nb, live, E, K, N, bm, empty,
                                            accumulate, dtype):
    """Gaussian rows: the kernel against the plain version in both dtypes
    (fp32: the FMA loop), write and add (``_assert_wgrad_close``)."""
    a, b, b2e, total, old = _wgrad_case(nb, live, E, K, N, bm, seed=nb + K, empty=empty,
                                        device=cuda)
    a, b, old = a.to(dtype), b.to(dtype), old.to(dtype)
    got = segment_outer(a, b, b2e, total, bm, old.clone(), accumulate=accumulate)
    want = ref.segment_outer_ref(a, b, b2e, total, old.clone(), accumulate)
    _assert_wgrad_close(got, want, a, b, b2e, total, accumulate)


@pytest.mark.cuda
def test_segment_outer_bf16_is_deterministic(cuda):
    """Many rows per expert (a long ring of stages): 8 relaunches equal the
    first bit for bit, in both modes."""
    a, b, b2e, total, old = _wgrad_case(24, 22, 4, 512, 1024, 128, seed=3, device=cuda)
    a, b, old = a.bfloat16(), b.bfloat16(), old.bfloat16()
    for accumulate in (False, True):
        first = segment_outer(a, b, b2e, total, 128, old.clone(), accumulate=accumulate)
        for _ in range(8):
            torch.testing.assert_close(
                segment_outer(a, b, b2e, total, 128, old.clone(), accumulate=accumulate),
                first, rtol=0, atol=0)
        _assert_wgrad_close(first, ref.segment_outer_ref(a, b, b2e, total, old.clone(),
                                                         accumulate), a, b, b2e, total,
                            accumulate)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["fused", "ragged"])
def test_chunking_does_not_raise_the_ep_layers_backward_peak(cuda, leg):
    """The EP layer's forward + backward peak at (chunks 2, depth 1) is not
    above (1, 1)'s, as in the JAX package, at a width where one set of
    expert-weight gradients (3 x 33.6 MB of bf16) outweighs a chunk's
    activations: each chunk's backward adds into one buffer per weight."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe

    E, d, f, T = 8, 2048, 1024, 256
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=f)
    g = torch.Generator(device="cpu").manual_seed(0)
    params = {"router": {"w": torch.randn((d, E), generator=g) * d ** -0.5,
                         "bias": torch.zeros(E)},
              "w1": torch.randn((E, d, f), generator=g) * d ** -0.5,
              "w3": torch.randn((E, d, f), generator=g) * d ** -0.5,
              "w2": torch.randn((E, f, d), generator=g) * f ** -0.5}
    params = {k: ({n: t.to(cuda).requires_grad_() for n, t in v.items()}
                  if isinstance(v, dict) else v.to(cuda, torch.bfloat16).requires_grad_())
              for k, v in params.items()}
    x = torch.randn((1, T, d), generator=g).to(cuda, torch.bfloat16)
    leaves = [params["w1"], params["w3"], params["w2"], params["router"]["w"]]
    peaks = {}
    for chunks in (1, 2, 1, 2):
        ctx = moe.DistContext(device=cuda, moe_strategy="ep_shardmap", moe_chunks=chunks,
                              moe_fused=leg == "fused", moe_ragged=leg == "ragged",
                              ragged_block=64)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, st = moe.moe_ffn(params, x, cfg, ctx)
        grads = torch.autograd.grad((y.float() ** 2).sum() + st["aux_loss"], leaves)
        torch.cuda.synchronize()
        peaks[chunks] = torch.cuda.max_memory_allocated() - base
        assert all(torch.isfinite(t.float()).all() for t in grads)
        del y, st, grads
    print(f"{leg} leg: forward + backward peak {peaks[1] / 1e6:.1f} MB at (1, 1), "
          f"{peaks[2] / 1e6:.1f} MB at (2, 1)")
    assert peaks[2] <= peaks[1], (f"{leg} leg: forward + backward peak {peaks[2] / 1e6:.1f} "
                                  f"MB at (2, 1) above {peaks[1] / 1e6:.1f} MB at (1, 1)")


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# (BH, S, Skv, hd, causal, window): tile edges (64 and 128 rows) met and
# missed, a window that does not divide the tile, Skv != S both ways, hd
# 8..128; then long sequences, where the bf16 kernel's band has interior
# tiles that skip the mask, causal with and without a window
FLASH_CASES = [(2, 64, 64, 64, True, 0), (3, 200, 200, 128, True, 16),
               (2, 130, 190, 24, False, 100), (2, 257, 257, 8, True, 70),
               (1, 100, 60, 128, True, 0), (2, 64, 96, 40, False, 0),
               (2, 300, 300, 128, False, 37), (4, 1024, 1024, 128, True, 0),
               (4, 1024, 1024, 128, True, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,Skv,hd,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, BH, S, Skv, hd, causal, window,
                                              dtype):
    g = torch.Generator(device="cpu").manual_seed(S + hd)
    q = torch.randn((BH, S, hd), generator=g).to(cuda, dtype)
    k, v = (torch.randn((BH, Skv, hd), generator=g).to(cuda, dtype) for _ in range(2))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=FLASH_TOL[dtype],
                               atol=FLASH_TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 12), device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 136), device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        flash_attention(q, q, q)


@pytest.mark.cuda
def test_training_on_the_local_path_raises_on_the_card(cuda):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no backward"):
        train.main(["--arch", "mixtral-8x7b", "--smoke", "--steps", "1"])


# -- EP across ranks on the one card -----------------------------------------

def _ep_rank(rank: int, shape: tuple, store: str, out: str, what: str) -> None:
    """One gloo rank on the card (spawned: CUDA cannot be forked); writes
    what it measured to out/rank<r>.json."""
    import json
    from pathlib import Path

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = mesh_lib.init_world(rank, shape[0] * shape[1], store, "cuda")
        mesh = mesh_lib.make_host_mesh(shape)
        if what == "losses":
            rec = _ep_losses(mesh, dev)
        else:
            rec = _ep_layer_errors(mesh, dev, placed=what == "placed")
        Path(out, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ep_layer_errors(mesh, dev, placed: bool = False) -> dict:
    """The EP layer on this rank's E / P experts through the kernels (CUDA
    tensors) and through their plain versions (the same inputs on the
    CPU), over the same mesh: the largest differences of y and of every
    gradient, per leg, and each leg's kernel launches.  ``placed``: under
    a placement with one replica slot per rank (E_local = E / P + 1)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import moe
    from repro_torch.core.placement import plan_placement
    E, d, f, T = 8, 256, 512, 128
    spec = (plan_placement([100, 50, 1, 1, 1, 1, 1, 1], mesh.peers, replicas=1)
            if placed else None)
    cfg = MoEConfig(num_experts=E, top_k=2, d_ff_expert=f)
    g = torch.Generator().manual_seed(0)
    full = {"router": torch.randn((d, E), generator=g) * d ** -0.5,
            "w1": torch.randn((E, d, f), generator=g) * d ** -0.5,
            "w3": torch.randn((E, d, f), generator=g) * d ** -0.5,
            "w2": torch.randn((E, f, d), generator=g) * f ** -0.5}
    full["router"][:, 0] += 1.0                            # uneven loads
    x = torch.randn((mesh.size, 1, T, d), generator=g)[mesh.rank]
    rec = {}
    for leg in ("fused", "ragged"):
        outs = []
        for device in (torch.device("cpu"), dev):
            for fn in _cuda.wrappers():
                fn.launches = 0
            params = {"router": {"w": full["router"].to(device).requires_grad_(),
                                 "bias": torch.zeros(E, device=device)},
                      **{k: mesh.local_experts(full[k]).to(device).requires_grad_()
                         for k in ("w1", "w3", "w2")}}
            xd = x.to(device).requires_grad_()
            ctx = moe.DistContext(device=device, mesh=mesh, moe_strategy="ep_shardmap",
                                  moe_chunks=2, moe_fused=leg == "fused",
                                  moe_ragged=leg == "ragged", ragged_block=64,
                                  placement=spec)
            y, st = moe.moe_ffn(params, xd, cfg, ctx)
            leaves = [xd, params["router"]["w"], params["w1"], params["w3"], params["w2"]]
            grads = torch.autograd.grad((y ** 2).sum() + st["aux_loss"], leaves)
            outs.append([y.detach().cpu()] + [t.cpu() for t in grads])
            launches = {fn.__name__: fn.launches for fn in _cuda.wrappers() if fn.launches}
        rec[leg] = {"errors": [(a - b).abs().max().item() / (1 + b.abs().max().item())
                               for a, b in zip(outs[1], outs[0])],
                    "launches": launches,
                    "slots": spec.slots_per_peer if spec else E // mesh.peers}
    return rec


def _ep_losses(mesh, dev) -> dict:
    """2 reduced fp32 training steps per leg on the card and on the CPU."""
    from repro_torch.training.step import make_train_state
    from repro_torch.training.trainer import Trainer
    cfg = get_config("mixtral-8x7b").reduced()
    rec = {}
    for leg in ("fused", "ragged"):
        for side, device in (("cpu", torch.device("cpu")), ("card", dev)):
            ctx = DistContext(device=device, moe_strategy="ep_shardmap", mesh=mesh,
                              moe_fused=leg == "fused", moe_ragged=leg == "ragged")
            params = transformer.init_params(cfg, device="cpu", seed=2, mesh=mesh)
            trainer = Trainer(cfg, ctx, seq_len=64, global_batch=2, lr=1e-3)
            trainer.fit(2, make_train_state(_tree_to(params, device)))
            rec[f"{leg}/{side}"] = {
                "losses": [r["loss"] for r in trainer.log],
                "schedules": [trainer.chunk_trace, trainer.pipeline_trace]}
    return rec


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _run_ep_ranks(shape: tuple, tmp_path, what: str) -> list:
    import json
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    n = shape[0] * shape[1]
    procs = [ctx.Process(target=_ep_rank, args=(r, shape, f"file://{tmp_path}/store",
                                                  str(tmp_path), what))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
        assert not any(p.is_alive() for p in procs), "a rank did not finish in 300 s"
        assert [p.exitcode for p in procs] == [0] * n
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["E_local4", "E_local2"])
def test_ep_layer_kernels_match_their_plain_versions_across_ranks(cuda, shape, tmp_path):
    """The EP layer over a mesh of gloo ranks sharing the card: the kernels
    against their plain versions through the same exchange, fp32, at
    E_local 4 (two ranks) and 2 (four ranks); every kernel of each leg
    launched on every rank."""
    want = {"fused": {"fused_moe", "ragged_matmul", "scatter_rows", "gather_combine",
                      "segment_outer"},
            "ragged": {"ragged_swiglu", "ragged_matmul", "scatter_rows",
                       "gather_combine", "segment_outer"}}
    for r, rec in enumerate(_run_ep_ranks(shape, tmp_path, "layer")):
        for leg, got in rec.items():
            assert max(got["errors"]) <= 1e-4, (r, leg, got["errors"])
            assert set(got["launches"]) == want[leg], (r, leg, got["launches"])


@pytest.mark.cuda
def test_placed_ep_layer_kernels_match_their_plain_versions_at_five_slots(cuda,
                                                                         tmp_path):
    """The EP layer under a placement with one replica slot per rank, on 2
    gloo ranks sharing the card: the kernels at E_local 5 (the slot
    weights gathered over the exchange) against their plain versions,
    fp32, every kernel of each leg launched on every rank."""
    want = {"fused": {"fused_moe", "ragged_matmul", "scatter_rows", "gather_combine",
                      "segment_outer"},
            "ragged": {"ragged_swiglu", "ragged_matmul", "scatter_rows",
                       "gather_combine", "segment_outer"}}
    for r, rec in enumerate(_run_ep_ranks((1, 2), tmp_path, "placed")):
        for leg, got in rec.items():
            assert got["slots"] == 5
            assert max(got["errors"]) <= 1e-4, (r, leg, got["errors"])
            assert set(got["launches"]) == want[leg], (r, leg, got["launches"])


@pytest.mark.cuda
def test_two_ranks_on_the_card_reproduce_the_cpu_losses(cuda, tmp_path):
    """2 reduced fp32 training steps per leg on a 1x2 mesh of gloo ranks
    sharing the card equal the same ranks' steps on the CPU (the
    tolerances of chip_smoke.py's check phase) with the same schedules."""
    for rec in _run_ep_ranks((1, 2), tmp_path, "losses"):
        for leg, tol in (("fused", 1e-4), ("ragged", 1e-5)):
            card, cpu = rec[f"{leg}/card"], rec[f"{leg}/cpu"]
            assert card["schedules"] == cpu["schedules"]
            np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=0, atol=tol)


# -- the serving engine's CUDA graphs ----------------------------------------

# (prompt length, generated tokens): 6 requests through 2 slots, prompts of
# one and several 16-token chunks and one shorter than a chunk; the reduced
# config's 64-token window makes the cache_len-80 pool's caches rings
SERVE_TRACE = [(16, 8), (48, 24), (32, 12), (20, 40), (64, 10), (8, 5)]


def _reduced(device, dtype=torch.float32, seed=0):
    cfg = get_config("mixtral-8x7b").reduced()
    return cfg, transformer.init_params(cfg, device=device, dtype=dtype, seed=seed)


def _serve(params, cfg, device, eager: bool):
    """Greedy streams, admission order and (decode waves, prefill chunks)."""
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                    max_new_tokens=g) for i, (S, g) in enumerate(SERVE_TRACE)]
    sched = ContinuousBatchingScheduler(
        params, cfg, DistContext(device=device),
        ServeConfig(max_slots=2, cache_len=80, prefill_chunk=16), eager=eager)
    m = sched.run(reqs)
    return ([r.out for r in reqs], sched.admission_order,
            (m["decode_waves"], m["prefill_chunks"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_serving_equals_eager_bit_for_bit(cuda, dtype):
    cfg, params = _reduced(cuda, dtype)
    ctx = DistContext(device=cuda)
    engine.clear_step_cache()
    eager = _serve(params, cfg, cuda, eager=True)
    assert engine.step_cache_info()["graphs"] == 0
    assert _serve(params, cfg, cuda, eager=False) == eager
    # decode, prefill at 16 and 8 tokens, extend at 16 and 4
    assert engine.step_cache_info()["graphs"] == 5
    engine.clear_step_cache()
    step = engine.get_decode_step(cfg, ctx)
    a = engine.init_serve_cache(params, cfg, 2, 80)
    b = engine.init_serve_cache(params, cfg, 2, 80)
    gen = torch.Generator(device="cpu").manual_seed(3)
    for _ in range(3):              # the capturing call, then two replays
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen).to(cuda)
        got, a = step(params, a, tok)
        want, b = step.eager(params, b, tok)
        assert torch.equal(got, want)
    assert all(torch.equal(x, y) for x, y in zip(engine.leaves(a), engine.leaves(b)))
    engine.clear_step_cache()


@pytest.mark.cuda
def test_second_parameter_set_gets_its_own_graphs(cuda):
    cfg, pa = _reduced(cuda, seed=0)
    _, pb = _reduced(cuda, seed=1)
    engine.clear_step_cache()
    a = _serve(pa, cfg, cuda, eager=False)
    graphs = engine.step_cache_info()["graphs"]
    b = _serve(pb, cfg, cuda, eager=False)
    assert engine.step_cache_info()["graphs"] == 2 * graphs
    assert b == _serve(pb, cfg, cuda, eager=True) and b[0] != a[0]
    # the graphs hold no reference to their weights
    dead = weakref.ref(pa["embed"])
    del pa
    gc.collect()
    assert dead() is None
    engine.clear_step_cache()


@pytest.mark.cuda
def test_launch_counts_hold_under_replay(cuda):
    cfg, params = _reduced(cuda)
    n_moe = transformer.num_moe_layers(cfg)
    engine.clear_step_cache()
    step = engine.get_decode_step(cfg, DistContext(device=cuda))
    cache = engine.init_serve_cache(params, cfg, 2, 80)
    tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
    before = (gm.grouped_swiglu.launches, gm.grouped_matmul.launches)
    for _ in range(4):
        step(params, cache, tok)
    torch.cuda.synchronize()
    assert step.captures == 1 and step.graphs() == 1
    assert (gm.grouped_swiglu.launches - before[0],
            gm.grouped_matmul.launches - before[1]) == (4 * n_moe, 4 * n_moe)
    engine.clear_step_cache()


@pytest.mark.cuda
def test_eager_steps_make_no_host_sync(cuda):
    """What a graph cannot hold: a step that waits for the card."""
    cfg, params = _reduced(cuda)
    ctx = DistContext(device=cuda)
    seg = torch.arange(24, device=cuda).reshape(2, 12)
    tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cache, _ = engine.get_prefill_fn(cfg, ctx, 80).eager(params,
                                                                {"tokens": seg})
        engine.get_extend_step(cfg, ctx).eager(params, cache, seg)
        engine.get_decode_step(cfg, ctx).eager(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    engine.clear_step_cache()


@pytest.mark.cuda
def test_a_capture_that_syncs_raises_and_runs_nothing_eagerly(cuda, monkeypatch):
    cfg, params = _reduced(cuda)
    ctx = DistContext(device=cuda)
    unembed = transformer.unembed

    def syncing(p, c, x):
        float(x.sum())              # a host sync inside the step
        return unembed(p, c, x)

    engine.clear_step_cache()
    step = engine.get_decode_step(cfg, ctx)
    cache = engine.init_serve_cache(params, cfg, 2, 80)
    tok = torch.zeros((2, 1), dtype=torch.long, device=cuda)
    monkeypatch.setattr(transformer, "unembed", syncing)
    with pytest.raises(RuntimeError, match="captur"):
        step(params, cache, tok)
    assert step.graphs() == 0 and step.captures == 0
    monkeypatch.undo()
    torch.cuda.synchronize()        # the card is still usable
    logits, _ = step(params, cache, tok)
    assert step.graphs() == 1 and bool(torch.isfinite(logits).all())
    engine.clear_step_cache()


# -- the paged serving path's decode graph -----------------------------------

def _paged_pool(params, cfg, cuda, cache_len, prompt, eager):
    """A 2-slot pool holding one request's prefill of ``prompt`` tokens."""
    from repro_torch.serving.paged_cache import PagedCachePool
    ctx = DistContext(device=cuda)
    toks = torch.arange(prompt, device=cuda).remainder(cfg.vocab_size)[None]
    logits, cache = engine.prefill_chunked(params, cfg, ctx, toks, cache_len, 8)
    pool = PagedCachePool(params, cfg, ctx, 2, cache_len, 8, eager=eager)
    rp = pool.ops.new_request()
    pool.install(rp, cache, prompt)
    return pool, rp, logits, cache


@pytest.mark.cuda
@pytest.mark.parametrize("cache_len,prompt", [(48, 20), (96, 72)])
def test_paged_decode_graph_replay_equals_eager(cuda, cache_len, prompt):
    """The paged wave's graph (pools as its static cache, tables copied in)
    against its eager function over 12 waves across page boundaries: logits
    and pools bit for bit, one capture."""
    cfg, params = _reduced(cuda)
    engine.clear_step_cache()
    graph_pool, rp_g, logits, _ = _paged_pool(params, cfg, cuda, cache_len, prompt, False)
    eager_pool, rp_e, _, _ = _paged_pool(params, cfg, cuda, cache_len, prompt, True)
    tok = int(logits[0, -1].argmax())
    for i in range(12):
        toks = np.asarray([[tok], [0]])
        pos = np.asarray([prompt + i, 0])
        for pool, rp in ((graph_pool, rp_g), (eager_pool, rp_e)):
            pool.prepare_decode_write(rp, prompt + i)
        got = graph_pool.decode_wave(params, [rp_g, None], pos, toks)
        want = eager_pool.decode_wave(params, [rp_e, None], pos, toks)
        assert torch.equal(got, want), f"wave {i}"
        tok = int(want[0, -1].argmax())
    assert rp_g.tables == rp_e.tables
    for a, b in zip(engine.leaves(graph_pool.pools), engine.leaves(eager_pool.pools)):
        assert torch.equal(a[2:], b[2:])     # the scratch page's writes have no order
    assert graph_pool._decode.captures == 1
    engine.clear_step_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("cache_len,prompt", [(48, 20), (96, 72)])
def test_paged_decode_equals_the_slot_map_on_the_card(cuda, cache_len, prompt):
    """Compiled paged waves against the compiled slot-map decode step on a
    2-slot pool (slot 1 empty): the occupied slot's logits bit for bit."""
    from repro_torch.serving.scheduler import _copy_row
    cfg, params = _reduced(cuda)
    engine.clear_step_cache()
    pool, rp, logits, cache = _paged_pool(params, cfg, cuda, cache_len, prompt, False)
    slots = engine.init_serve_cache(params, cfg, 2, cache_len)
    _copy_row(slots, cache, 0)
    step = engine.get_decode_step(cfg, DistContext(device=cuda))
    tok = int(logits[0, -1].argmax())
    for i in range(12):
        toks = torch.tensor([[tok], [0]], device=cuda)
        want, slots = step(params, slots, toks)
        pool.prepare_decode_write(rp, prompt + i)
        got = pool.decode_wave(params, [rp, None], np.asarray([prompt + i, 0]),
                               toks.cpu().numpy())
        assert torch.equal(got[0], want[0]), f"wave {i}"
        tok = int(want[0, -1].argmax())
    engine.clear_step_cache()


def _paged_serve(params, cfg, cuda, eager, inject=None, sched=None):
    """The serving trace through the paged scheduler with prefix cache and
    preemption: (streams, admission order, (waves, chunks, faults))."""
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.serving.paged_scheduler import PagedScheduler
    rng = np.random.default_rng(7)
    stem = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    reqs = [Request(rid=i, tokens=np.concatenate(
                [stem, rng.integers(0, cfg.vocab_size, S).astype(np.int32)]),
                max_new_tokens=g) for i, (S, g) in enumerate(SERVE_TRACE[:4])]
    if sched is None:
        sched = PagedScheduler(
            params, cfg, DistContext(device=cuda),
            ServeConfig(max_slots=2, cache_len=96, prefill_chunk=16, page_size=16,
                        prefix_cache=True, preemption=True), eager=eager,
            injector=FaultInjector.from_string(inject) if inject else None)
    m = sched.run(reqs)
    return ([r.out for r in reqs], list(sched.admission_order),
            (m["decode_waves"], m["prefill_chunks"], m["faults"])), sched


@pytest.mark.cuda
def test_paged_scheduler_compiled_equals_eager_and_the_slot_map(cuda):
    cfg, params = _reduced(cuda)
    engine.clear_step_cache()
    eager, _ = _paged_serve(params, cfg, cuda, eager=True)
    compiled, sched = _paged_serve(params, cfg, cuda, eager=False)
    assert compiled == eager
    assert sched.pool._decode.graphs() == 1
    assert sched.metrics(1.0)["prefix_hits"] >= 1
    slot_map = ContinuousBatchingScheduler(
        params, cfg, DistContext(device=cuda),
        ServeConfig(max_slots=2, cache_len=96, prefill_chunk=16))
    rng = np.random.default_rng(7)
    stem = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    reqs = [Request(rid=i, tokens=np.concatenate(
                [stem, rng.integers(0, cfg.vocab_size, S).astype(np.int32)]),
                max_new_tokens=g) for i, (S, g) in enumerate(SERVE_TRACE[:4])]
    slot_map.run(reqs)
    assert [r.out for r in reqs] == compiled[0]
    engine.clear_step_cache()


@pytest.mark.cuda
def test_rebuild_keeps_the_pools_pointers_and_the_warm_graph(cuda):
    """A faulted wave on the card zeroes the pools in place: every pool
    keeps its data_ptr, the warm graph replays after it (no new capture),
    and the streams equal the unfaulted run's."""
    cfg, params = _reduced(cuda)
    engine.clear_step_cache()
    clean, sched = _paged_serve(params, cfg, cuda, eager=False)
    ptrs = [t.data_ptr() for t in engine.leaves(sched.pool.pools)]
    captures = sched.pool._decode.captures
    sched._rebuild_pools()
    assert [t.data_ptr() for t in engine.leaves(sched.pool.pools)] == ptrs
    assert all(not t.any() for t in engine.leaves(sched.pool.pools))
    again, _ = _paged_serve(params, cfg, cuda, eager=False, sched=sched)
    assert again[0] == clean[0]
    assert again[1][len(clean[1]):] == clean[1]     # this run's admissions
    assert sched.pool._decode.captures == captures
    faulted, fs = _paged_serve(params, cfg, cuda, eager=False, inject="oom@6")
    assert faulted[0] == clean[0] and faulted[2][2] == 1
    fs.pool.alloc.audit()
    engine.clear_step_cache()


@pytest.mark.cuda
def test_paged_wave_makes_no_host_sync(cuda):
    """The paged decode wave's eager function holds nothing a graph cannot."""
    cfg, params = _reduced(cuda)
    engine.clear_step_cache()
    pool, rp, _, _ = _paged_pool(params, cfg, cuda, 96, 72, True)
    pool.prepare_decode_write(rp, 72)
    step = pool._decode
    args = (pool.pools, pool._tables([rp, None]), pool._write_pages([rp, None], [72, 0]),
            pool._state_blocks([rp, None]), pool._ids([72, 0]), pool._ids([[1], [0]]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.eager(params, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    engine.clear_step_cache()


# -- expert-aware serving: masked waves and the residency tier ---------------

@pytest.mark.cuda
def test_masked_decode_graph_equals_eager(cuda):
    """The masked subset wave's graph against its eager function over waves
    with changing masks: logits, cache and per-slot loads bit for bit, one
    capture, and the eager function makes no host sync."""
    cfg, params = _reduced(cuda)
    ctx = DistContext(device=cuda)
    engine.clear_step_cache()
    step = engine.get_decode_step_masked(cfg, ctx)
    a = engine.init_serve_cache(params, cfg, 3, 80)
    b = engine.init_serve_cache(params, cfg, 3, 80)
    gen = torch.Generator(device="cpu").manual_seed(5)
    masks = ([1, 1, 1], [1, 0, 1], [0, 1, 0], [1, 1, 0], [1, 1, 1])
    for m in masks:
        tok = torch.randint(0, cfg.vocab_size, (3, 1), generator=gen).to(cuda)
        mask = torch.tensor(m, dtype=torch.bool, device=cuda)
        got, a, load_g = step(params, a, tok, mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            want, b, load_e = step.eager(params, b, tok, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got, want) and torch.equal(load_g, load_e)
        assert all(torch.equal(x, y) for x, y in zip(engine.leaves(a), engine.leaves(b)))
    assert a["pos"].tolist() == [4, 4, 3]
    assert step.captures == 1
    engine.clear_step_cache()


@pytest.mark.cuda
def test_paged_decode_wave_loads_graph_equals_eager(cuda):
    """The paged loads wave's graph against its eager function: logits,
    loads and pools bit for bit, one capture."""
    from repro_torch.serving.paged_cache import PagedCachePool
    cfg, params = _reduced(cuda)
    ctx = DistContext(device=cuda)
    engine.clear_step_cache()
    toks = torch.arange(72, device=cuda)[None]
    logits, cache = engine.prefill_chunked(params, cfg, ctx, toks, 96, 8)
    pools, rps = [], []
    for eager in (False, True):
        pool = PagedCachePool(params, cfg, ctx, 2, 96, 8, eager=eager)
        rp = pool.ops.new_request()
        pool.install(rp, cache, 72)
        pools.append(pool)
        rps.append(rp)
    tok = int(logits[0, -1].argmax())
    for i in range(8):
        outs = []
        for pool, rp in zip(pools, rps):
            pool.prepare_decode_write(rp, 72 + i)
            outs.append(pool.decode_wave_loads(params, [rp, None],
                                               np.asarray([72 + i, 0]),
                                               np.asarray([[tok], [0]])))
        (lg_g, ld_g), (lg_e, ld_e) = outs
        assert torch.equal(lg_g, lg_e) and torch.equal(ld_g, ld_e), f"wave {i}"
        assert float(ld_g[0].sum()) == cfg.moe.top_k * transformer.num_moe_layers(cfg)
        tok = int(lg_e[0, -1].argmax())
    for x, y in zip(engine.leaves(pools[0].pools), engine.leaves(pools[1].pools)):
        assert torch.equal(x[2:], y[2:])
    assert pools[0]._decode.captures == 1
    engine.clear_step_cache()


def _expert_serve(params, cfg, cuda, **kw):
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                    max_new_tokens=g) for i, (S, g) in enumerate(SERVE_TRACE)]
    sched = ContinuousBatchingScheduler(
        params, cfg, DistContext(device=cuda),
        ServeConfig(max_slots=2, cache_len=80, prefill_chunk=16, **kw))
    m = sched.run(reqs)
    return [r.out for r in reqs], m, sched


@pytest.mark.cuda
def test_residency_keeps_weight_pointers_and_warm_graphs(cuda):
    """The tier writes the weights in place: every weight keeps its
    data_ptr through offloads and restores, a second residency run captures
    no graph (restores do not re-key the steps), a restore is bit-equal to
    the host mirror, the mirror is pinned, streams equal the all-resident
    run's, and ``close`` gives back the original bits."""
    cfg, params = _reduced(cuda)
    engine.clear_step_cache()
    flat0 = [t.clone() for t in engine.leaves(params)]
    ptrs = [t.data_ptr() for t in engine.leaves(params)]
    base, _, _ = _expert_serve(params, cfg, cuda)
    kw = dict(wave_size=1, expert_batching=True, resident_experts=1)
    first, m, sched = _expert_serve(params, cfg, cuda, **kw)
    assert first == base and m["residency"]["restores"] > 0
    assert [t.data_ptr() for t in engine.leaves(params)] == ptrs
    res = sched.residency
    assert res.host[0]["w1"].is_pinned()
    j = 0
    cold = next(e for e in range(res.num_experts) if e not in res.resident[j])
    w1 = params["layers"][res.refs[j]]["ffn"]["w1"]
    assert not w1[cold].any()
    res.ensure(params, [(j, cold)])
    torch.cuda.synchronize()
    assert torch.equal(w1[cold].cpu(), res.host[j]["w1"][cold])
    sched.close()
    del sched, res
    gc.collect()
    captures = engine.step_cache_info()["captures"]
    again, m2, sched = _expert_serve(params, cfg, cuda, **kw)
    assert again == base and m2["demand_reruns"] == m["demand_reruns"]
    assert engine.step_cache_info()["captures"] == captures
    sched.close()
    assert all(torch.equal(a, b) for a, b in zip(flat0, engine.leaves(params)))
    assert [t.data_ptr() for t in engine.leaves(params)] == ptrs
    engine.clear_step_cache()


# -- state-carrying models: mamba layers' state in the graphs' caches -------

HYBRIDS = ("jamba-1.5-large-398b", "mamba2-130m")


def _hybrid(arch, device):
    cfg = get_config(arch).reduced()
    return cfg, transformer.init_params(cfg, device=device, seed=0)


def _hybrid_serve(params, cfg, cuda, eager=False, hook=None, **kw):
    """Streams, metrics and the data_ptr of every state leaf of the slot
    pool (or the page pools) before and after the run.  The scheduler is
    dropped at the end, so the next run takes over its static caches and
    warm graphs."""
    from repro_torch.serving.paged_scheduler import PagedScheduler
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, S).astype(np.int32),
                    max_new_tokens=g) for i, (S, g) in enumerate(SERVE_TRACE)]
    cls = PagedScheduler if kw.get("page_size") else ContinuousBatchingScheduler
    sched = cls(params, cfg, DistContext(device=cuda),
                ServeConfig(max_slots=2, cache_len=80, prefill_chunk=16, **kw),
                eager=eager)
    if hook is not None:
        hook(sched)
    if kw.get("page_size"):      # a mamba layer's pools: {"ssm", "conv"}
        state = [t for pool in sched.pool.pools if "ssm" in pool for t in pool.values()]
    else:
        state = [t for layer in sched.cache["layers"] if "ssm" in layer
                 for t in layer["ssm"].values()]
    ptrs = [t.data_ptr() for t in state]
    try:
        m = sched.run(reqs)
    finally:
        sched.close()
    after = [t.data_ptr() for t in state]
    del sched, state
    gc.collect()
    return [r.out for r in reqs], m, (ptrs, after)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", HYBRIDS)
def test_hybrid_graphs_equal_eager_and_keep_the_state_in_place(cuda, arch):
    """Slot map and pages: compiled streams equal eager ones; every state
    leaf keeps its data_ptr across the replays; a second run on warm graphs
    captures nothing."""
    cfg, params = _hybrid(arch, cuda)
    engine.clear_step_cache()
    eager = _hybrid_serve(params, cfg, cuda, eager=True)[0]
    for kw in ({}, {"page_size": 16}):
        got, _, (before, after) = _hybrid_serve(params, cfg, cuda, **kw)
        assert got == eager and before == after and before
        captures = engine.step_cache_info()["captures"]
        again, _, (b2, a2) = _hybrid_serve(params, cfg, cuda, **kw)
        assert again == eager and b2 == a2
        assert engine.step_cache_info()["captures"] == captures
    engine.clear_step_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("page", [0, 16])
def test_hybrid_demand_reruns_restore_the_state_in_place(cuda, page):
    """Jamba, waves of 2, 1 resident expert per MoE layer, the prefetch off:
    decode waves re-run from the members' states put back in place; streams
    equal the all-resident run's, the state leaves keep their data_ptr, and
    a second run captures nothing across its restores."""
    cfg, params = _hybrid("jamba-1.5-large-398b", cuda)
    engine.clear_step_cache()
    kw = {"page_size": page} if page else {}
    base = _hybrid_serve(params, cfg, cuda, **kw)[0]

    def no_prefetch(sched):
        sched.residency.prefetch = lambda p, predicted: None
    tier = dict(kw, wave_size=2, resident_experts=1)
    got, m, (before, after) = _hybrid_serve(params, cfg, cuda, hook=no_prefetch,
                                            **tier)
    assert got == base and m["demand_reruns"] > 0 and before == after
    captures = engine.step_cache_info()["captures"]
    again = _hybrid_serve(params, cfg, cuda, hook=no_prefetch, **tier)[0]
    assert again == base and engine.step_cache_info()["captures"] == captures
    engine.clear_step_cache()


@pytest.mark.cuda
def test_masked_graph_keeps_non_members_state_bit_for_bit(cuda):
    """The masked wave's graph over rows with live state, masks changing
    between replays: non-members keep every cache leaf bit for bit, and the
    graph equals the eager step."""
    cfg, params = _hybrid("jamba-1.5-large-398b", cuda)
    ctx = DistContext(device=cuda)
    engine.clear_step_cache()
    seg = torch.arange(48, device=cuda).reshape(4, 12) % cfg.vocab_size
    _, prefilled, _ = engine.get_prefill_fn(cfg, ctx, 40).eager(params, {"tokens": seg})
    step = engine.get_decode_step_masked(cfg, ctx)
    a = engine._fill(prefilled, iter([t.clone() for t in engine.leaves(prefilled)]))
    b = engine._fill(prefilled, iter([t.clone() for t in engine.leaves(prefilled)]))
    for mask in ([True, False, True, False], [False, True, True, False],
                 [False, False, False, True]):
        mask = torch.tensor(mask, device=cuda)
        tok = torch.arange(4, device=cuda)[:, None] + 3
        before = [t.clone() for t in engine.leaves(a)]
        got, a, _ = step(params, a, tok, mask)
        want, b, _ = step.eager(params, b, tok, mask)
        assert torch.equal(got, want)
        for x, y, z in zip(engine.leaves(a), before, engine.leaves(b)):
            assert torch.equal(x[~mask], y[~mask]) and torch.equal(x, z)
    assert step.captures == 1
    engine.clear_step_cache()


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


def test_each_grouped_route_states_its_own_m_limit():
    """The fp32 tile loop puts its 64-row M tiles on the grid's y axis; the
    bf16 weight stream walks a persistent grid and is held only to its int
    tile counter, not to the old grid's limit."""
    assert gm._max_m(torch.float32, 8, 14336) == 64 * 65535
    assert gm._max_m(torch.bfloat16, 8, 14336) == 64 * ((2 ** 31 - 1) // (8 * 112))
    assert gm._max_m(torch.bfloat16, 8, 14336) > 64 * 65535


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    x, w1, w3 = _inputs(2, 3, 16, 8, 2, torch.float32, "cpu")
    before = (gm.grouped_swiglu.launches, gm.grouped_matmul.launches)
    torch.testing.assert_close(gm.grouped_swiglu(x, w1, w3),
                               ref.grouped_swiglu_ref(x, w1, w3), rtol=0, atol=0)
    torch.testing.assert_close(gm.grouped_matmul(x, w1),
                               ref.grouped_matmul_ref(x, w1), rtol=0, atol=0)
    assert (gm.grouped_swiglu.launches, gm.grouped_matmul.launches) == before


def test_new_kernels_take_the_plain_version_on_the_cpu():
    (x, w1, w3, w2, wslot, wtk), (slots, b2e, total, src), _ = _ragged_case(
        24, 2, 4, 16, 32, 8, torch.float32, "cpu")
    counters = (dc.scatter_rows, dc.gather_combine, ragged_matmul, fused_moe)
    before = [c.launches for c in counters]
    buf = dc.scatter_rows(x, src, total, wslot)
    torch.testing.assert_close(buf, ref.scatter_rows_ref(x, src, total, wslot),
                               rtol=0, atol=0)
    torch.testing.assert_close(dc.gather_combine(buf, slots, wtk),
                               ref.gather_combine_ref(buf, slots, wtk), rtol=0, atol=0)
    torch.testing.assert_close(ragged_matmul(buf, w1, b2e, total, 8),
                               ref.ragged_matmul_ref(buf, w1, b2e, total), rtol=0, atol=0)
    torch.testing.assert_close(fused_moe(x, w1, w3, w2, src, wslot, total, b2e),
                               ref.fused_moe_rows_ref(x, w1, w3, w2, src, wslot, b2e,
                                                      total), rtol=0, atol=0)
    assert [c.launches for c in counters] == before


def test_new_wrappers_check_their_arguments():
    (x, w1, w3, w2, wslot, _), (slots, b2e, total, src), R = _ragged_case(
        24, 2, 4, 16, 32, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="weights of shape"):
        dc.scatter_rows(x, src, total, wslot[:-1])
    with pytest.raises(ValueError, match="do not match"):
        ragged_matmul(x, w1[:, :8], b2e, total, 8)
    with pytest.raises(ValueError, match="blocks"):
        ragged_matmul(x, w1, b2e, total, 8)          # T rows, not the R of b2e
    with pytest.raises(ValueError, match="do not match"):
        fused_moe(x, w1, w3, w1, src, wslot, total, b2e)
    with pytest.raises(ValueError, match="divide or be a multiple"):
        from repro_torch.kernels.ragged_mlp import row_tile
        row_tile(48)


@pytest.mark.parametrize("bm,wide,rows", [(8, False, 8), (64, False, 64), (128, False, 64),
                                           (8, True, 8), (32, True, 32), (64, True, 64),
                                           (128, True, 128), (192, True, 64),
                                           (256, True, 128)])
def test_row_tile_never_straddles_two_row_blocks(bm, wide, rows):
    """The rows a tile keeps: the tile loop's 64, the bf16 ragged_matmul
    kernel's 128 where bm allows it, or the whole row block when it is
    smaller; a tile never holds two experts."""
    from repro_torch.kernels.ragged_mlp import row_tile
    assert row_tile(bm, wide=wide) == rows
    assert bm % rows == 0


def test_segment_outer_takes_the_plain_version_on_the_cpu():
    a, b, b2e, total, old = _wgrad_case(6, 4, 3, 16, 24, 8, seed=1)
    before = segment_outer.launches
    for accumulate in (False, True):
        torch.testing.assert_close(
            segment_outer(a, b, b2e, total, 8, old.clone(), accumulate=accumulate),
            ref.segment_outer_ref(a, b, b2e, total, old.clone(), accumulate),
            rtol=0, atol=0)
    assert segment_outer.launches == before


def test_ragged_swiglu_and_flash_attention_take_the_plain_version_on_the_cpu():
    (x, w1, w3, w2, _, _), (_, b2e, total, src), _ = _ragged_case(
        24, 2, 4, 16, 32, 8, torch.float32, "cpu")
    buf = ref.scatter_rows_ref(x, src, total)
    counters = (ragged_swiglu, ragged_matmul, flash_attention)
    before = [c.launches for c in counters]
    torch.testing.assert_close(ragged_swiglu(buf, w1, w3, b2e, total, 8),
                               ref.ragged_swiglu_ref(buf, w1, w3, b2e, total),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.ragged_expert_ffn(buf, w1, w3, w2, b2e, total,
                                                     block_m=8),
                               ref.ragged_expert_ffn_ref(buf, w1, w3, w2, b2e, total),
                               rtol=0, atol=0)
    q = torch.randn((2, 16, 8))
    torch.testing.assert_close(flash_attention(q, q, q, window=4),
                               ref.flash_attention_ref(q, q, q, causal=True, window=4),
                               rtol=0, atol=0)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="do not match"):
        ragged_swiglu(buf, w1, w3[:, :8], b2e, total, 8)
    with pytest.raises(ValueError, match="blocks"):
        ragged_swiglu(x, w1, w3, b2e, total, 8)


# ---------------------------------------------------------------------------
# the resilience path on the card: the transactional AdamW, a real OOM walked
# by the ladder, a bf16 checkpoint round trip
# ---------------------------------------------------------------------------

def _per_tensor_adamw(grads, mu, nu, params, step, lr, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1, clip_norm=1.0):
    """The update ``optim/adamw.py`` ran before it was sliced: one tensor at
    a time, its fp32 temporaries made after earlier tensors were written."""
    from repro_torch.optim.adamw import global_norm
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** step
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** step
    for p, g, m, v in zip(params, grads, mu, nu):
        gf = torch.zeros_like(m) if g is None else g.to(torch.float32) * scale.to(g.device)
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        u = (v / bc2.to(v.device)).sqrt_().add_(eps)
        u = (m / bc1.to(m.device)).div_(u)
        pf = p.to(torch.float32)
        u.add_(pf, alpha=weight_decay)
        p.copy_(pf.add_(u, alpha=-lr))


@pytest.mark.cuda
def test_adamw_allocates_nothing_after_its_first_write(cuda, monkeypatch):
    """From AdamW's first write to its return the allocator makes nothing
    (its workspace is the last allocation), and the sliced update equals the
    per-tensor one bit for bit."""
    from repro_torch.optim import adamw
    monkeypatch.setattr(adamw, "_SLICE_ELEMS", 1000)      # several slices a tensor
    gen = torch.Generator().manual_seed(0)
    specs = [((64, 48), torch.bfloat16), ((5,), torch.float32), ((3000,), torch.bfloat16),
             ((7, 300), torch.float32)]
    params = [torch.randn(s, generator=gen).to(cuda, dt) for s, dt in specs]
    grads = [torch.randn(s, generator=gen).to(cuda, dt) * 3 for s, dt in specs]
    grads[1] = None
    state = adamw.adamw_init(params)
    for m, v in zip(state.mu, state.nu):
        m.normal_()
        v.uniform_()
    twin = ([p.clone() for p in params], [m.clone() for m in state.mu],
            [v.clone() for v in state.nu])
    seen = []
    real = adamw._workspace

    def workspace(n, device):
        w = real(n, device)
        seen.append(torch.cuda.memory_stats()["allocation.all.allocated"])
        return w

    monkeypatch.setattr(adamw, "_workspace", workspace)
    new, _ = adamw.adamw_update(grads, state._replace(step=4), params, lr=1e-2)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert len(seen) == 1 and after == seen[0]
    _per_tensor_adamw(grads, twin[1], twin[2], twin[0], 5, 1e-2)
    for got, want in zip(params + new.mu + new.nu, twin[0] + twin[1] + twin[2]):
        assert torch.equal(got, want)


def _real_oom_child(out: str) -> None:
    """One step of a 1-layer reduced Mixtral with wide experts (f 4096,
    4096 tokens: the MoE backward sets the peak) at (1, 1), (2, 1) and
    (4, 1) from the same seed, then (1, 1) under a memory cap between the
    peaks of (1, 1) and (2, 1), through the trainer's guard.  Run in a
    process whose allocator maps expandable segments, so that what a step
    reserves under a cap follows what it allocates."""
    import dataclasses
    import hashlib
    import json

    from repro_torch.optim.adamw import param_list
    from repro_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("mixtral-8x7b").reduced()
    cfg = dataclasses.replace(base, num_layers=1,
                              moe=dataclasses.replace(base.moe, d_ff_expert=4096))
    total = torch.cuda.get_device_properties(0).total_memory

    def run(c, cap=None):
        gc.collect()
        torch.cuda.empty_cache()
        if cap:
            torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            tr = Trainer(cfg, DistContext(device=torch.device("cuda"),
                                          moe_strategy="ep_shardmap", moe_fused=True,
                                          moe_chunks=c, pipeline_chunks=1),
                         seq_len=128, global_batch=32, lr=1e-3, use_mact=False)
            state = tr.fit(1)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        h = hashlib.sha256()
        for t in param_list(state.params) + state.opt.mu + state.opt.nu:
            h.update(t.detach().cpu().numpy().tobytes())
        return {"loss": tr.log[0]["loss"], "chunks": tr.log[0]["chunks"],
                "allocated": torch.cuda.max_memory_allocated(), "digest": h.hexdigest(),
                "escalations": [e["error"] for e in tr.guard.escalations]}

    runs = {c: run(c) for c in (1, 2, 4)}
    cap = (runs[1]["allocated"] + runs[2]["allocated"]) / 2
    with open(out, "w") as f:
        json.dump({"runs": runs, "capped": run(1, cap)}, f)


@pytest.mark.cuda
def test_a_real_oom_is_rolled_back_and_the_retry_equals_the_rung(cuda, tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    out = tmp_path / "oom.json"
    code = (f"import sys; sys.path.insert(0, {str(Path(__file__).parent)!r}); "
            f"import test_torch_cuda as t; t._real_oom_child({str(out)!r})")
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    subprocess.run([sys.executable, "-c", code], env=env, timeout=600, check=True)
    rec = json.loads(out.read_text())
    runs, capped = rec["runs"], rec["capped"]
    assert runs["1"]["allocated"] - runs["2"]["allocated"] > 64 << 20
    assert capped["escalations"] and "CUDA out of memory" in capped["escalations"][0]
    rung = runs[str(capped["chunks"])]
    assert capped["chunks"] > 1
    assert (capped["loss"], capped["digest"]) == (rung["loss"], rung["digest"])


@pytest.mark.cuda
def test_bf16_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    from repro_torch import checkpointing
    from repro_torch.training.step import init_train_state
    cfg = get_config("mixtral-8x7b").reduced()
    saved = init_train_state(cfg, torch.bfloat16, cuda, seed=0)
    for m, v in zip(saved.opt.mu, saved.opt.nu):
        m.normal_()
        v.uniform_()
    saved = saved._replace(step=7, opt=saved.opt._replace(step=7))
    checkpointing.save(str(tmp_path), 7, saved)
    got = checkpointing.restore(str(tmp_path), 7,
                                init_train_state(cfg, torch.bfloat16, cuda, seed=1))
    assert (got.step, got.opt.step) == (7, 7)
    from repro_torch.optim.adamw import param_list
    for a, b in zip(param_list(got.params) + got.opt.mu + got.opt.nu,
                    param_list(saved.params) + saved.opt.mu + saved.opt.nu):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# runtime row tiles: the bf16 ragged_matmul, fused_moe's down pass and
# segment_outer at tm 64 and 128, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def tile_cache(tmp_path):
    from repro_torch.kernels import autotune
    path = str(tmp_path / "autotune.json")
    autotune.set_cache_path(path)
    yield path
    autotune.set_cache_path(None)


def _tile_blocks(nb, E, bm, seed):
    """Row blocks of ascending experts over E experts, one of them (and the
    last) empty, and a routed length that ends mid-block with dead blocks
    past it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    used = torch.tensor([e for e in range(E - 1) if e != 1])
    b2e = torch.sort(used[torch.randint(0, len(used), (nb,), generator=g)]).values
    total = torch.tensor((nb - 2) * bm - bm // 2 - 3, dtype=torch.int32)
    return b2e.to(torch.int32), total, g


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("bm", [128, 256])
def test_ragged_matmul_bf16_tiles_are_bit_equal(cuda, tile_cache, bm, trans):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ragged_mlp import tuned_row_tile
    nb, E, K, N = 7, 5, 200, 328
    b2e, total, g = _tile_blocks(nb, E, bm, seed=bm + trans)
    x = torch.randn((nb * bm, K), generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn((E, N, K) if trans else (E, K, N), generator=g) * K ** -0.5).to(
        cuda, torch.bfloat16)
    b2e, total = b2e.to(cuda), total.to(cuda)
    got = {tm: ragged_matmul(x, w, b2e, total, bm, transpose_w=trans, tm=tm)
           for tm in (64, 128)}
    assert torch.equal(got[64], got[128])
    assert (got[64][int(total):] == 0).all()
    _assert_close(got[64], ref.ragged_matmul_ref(x, w.transpose(1, 2) if trans else w,
                                                 b2e, total), torch.bfloat16)
    # through the cache as the path calls it: a cached 64 is taken
    op = "ragged_matmul_t" if trans else "ragged_matmul"
    shape = (nb * bm, K, N, E, bm)
    autotune.record(op, shape, torch.bfloat16, {"tm": 64})
    assert tuned_row_tile(op, shape, bm) == 64
    assert torch.equal(ragged_matmul(x, w, b2e, total, bm, transpose_w=trans), got[128])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("bm", [128, 256])
def test_fused_moe_bf16_down_tiles_are_bit_equal(cuda, tile_cache, bm, K):
    """The down pass at 64- and 128-row tiles, the up pass at 128 rows
    either way; at most two rows per token, so the atomic combine is
    order-free (0 + a + b).  Each expert's group ends in a partial block
    (padding rows), and dead blocks follow the routed ones."""
    (x, w1, w3, w2, wslot, _), (_, b2e, total, src), R = _ragged_case(
        200, K, 6, 136, 264, bm, torch.bfloat16, cuda, seed=bm + K, skew=True, dead=2)
    assert (src[:int(total)] < 0).any() and int(total) < R - bm
    got = {tm: fused_moe(x, w1, w3, w2, src, wslot, total, b2e, tm=tm) for tm in (64, 128)}
    assert torch.equal(got[64], got[128])
    _assert_close(got[64], ref.fused_moe_rows_ref(x, w1, w3, w2, src, wslot, b2e, total),
                  torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("bm", [128, 256])
def test_segment_outer_bf16_tiles_are_bit_equal(cuda, tile_cache, bm, accumulate):
    nb, E, K, N = 6, 5, 200, 264
    b2e, total, g = _tile_blocks(nb, E, bm, seed=3 * bm + accumulate)
    a, b = (torch.randn((nb * bm, n), generator=g).to(cuda, torch.bfloat16) for n in (K, N))
    old = torch.randn((E, K, N), generator=g).to(cuda, torch.bfloat16)
    b2e, total = b2e.to(cuda), total.to(cuda)
    got = {tm: segment_outer(a, b, b2e, total, bm, old.clone(), accumulate=accumulate,
                             tm=tm) for tm in (64, 128)}
    assert torch.equal(got[64], got[128])
    _assert_wgrad_close(got[64], ref.segment_outer_ref(a, b, b2e, total, old.clone(),
                                                       accumulate),
                        a, b, b2e, total, accumulate)
    for e in (1, E - 1):                           # experts with no rows
        assert torch.equal(got[64][e], old[e] if accumulate else torch.zeros_like(old[e]))


@pytest.mark.cuda
def test_autotune_on_the_card_persists_a_winner(cuda, tile_cache):
    from repro_torch.kernels import autotune
    a, b, b2e, total, old = _wgrad_case(12, 10, 4, 512, 1024, 128, seed=9, device=cuda)
    a, b, old = a.bfloat16(), b.bfloat16(), old.bfloat16()
    shape = (a.shape[0], 512, 1024, 4, 128)

    def make_fn(tm):
        return lambda: segment_outer(a, b, b2e, total, 128, torch.empty_like(old),
                                     accumulate=False, tm=tm)
    res = autotune.autotune("segment_outer", shape, torch.bfloat16, make_fn,
                            [{"tm": 64}, {"tm": 128}], baseline={"tm": 128}, device=cuda)
    assert not res.skipped and not res.refused
    assert {tuple(c.items()) for c, _ in res.table} == {(("tm", 64),), (("tm", 128),)}
    assert all(ms > 0 for _, ms in res.table) and res.baseline_ms is not None
    assert autotune.lookup("segment_outer", shape, torch.bfloat16) == res.winner
    autotune.set_cache_path(tile_cache)                 # read back from the file
    assert autotune.lookup("segment_outer", shape, torch.bfloat16) == res.winner
    assert autotune.device_kind() == torch.cuda.get_device_name().replace(" ", "_")


@pytest.mark.cuda
def test_an_illegal_cached_tile_is_replaced_by_the_default(cuda, tile_cache):
    """128 rows at bm 64 (ragged_matmul, fused_moe) and at K 64
    (segment_outer) are not tiles these kernels take: the wrappers launch
    the default instead, and raise nothing."""
    from repro_torch.kernels import autotune
    bm = 64
    x, w, b2e, total = (t.to(cuda) for t in _blocked_case(6, 5, 3, 64, 200, bm, False,
                                                          seed=11))
    x, w = x.bfloat16(), w.bfloat16()
    want = ragged_matmul(x, w, b2e, total, bm)
    autotune.record("ragged_matmul", (x.shape[0], 64, 200, 3, bm), torch.bfloat16,
                    {"tm": 128})
    assert torch.equal(ragged_matmul(x, w, b2e, total, bm), want)
    assert torch.equal(ragged_matmul(x, w, b2e, total, bm, tm=128), want)
    (xf, w1, w3, w2, wslot, _), (_, fb2e, ftotal, src), R = _ragged_case(
        60, 2, 4, 64, 136, bm, torch.bfloat16, cuda, seed=12)
    fwant = fused_moe(xf, w1, w3, w2, src, wslot, ftotal, fb2e)
    autotune.record("fused_moe", (R, 136, 64, 4, bm), torch.bfloat16, {"tm": 128})
    assert torch.equal(fused_moe(xf, w1, w3, w2, src, wslot, ftotal, fb2e), fwant)
    a, b, sb2e, stotal, old = _wgrad_case(5, 4, 3, 64, 256, 64, seed=13, device=cuda)
    a, b, old = a.bfloat16(), b.bfloat16(), old.bfloat16()
    swant = segment_outer(a, b, sb2e, stotal, 64, old.clone(), accumulate=True)
    autotune.record("segment_outer", (a.shape[0], 64, 256, 3, 64), torch.bfloat16,
                    {"tm": 128})
    assert torch.equal(segment_outer(a, b, sb2e, stotal, 64, old.clone(), accumulate=True),
                       swant)
    torch.cuda.synchronize()
