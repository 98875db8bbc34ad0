"""Grouped (per-expert) matmul and fused SwiGLU: the CUDA kernels' wrappers.

``grouped_swiglu`` and ``grouped_matmul`` take the capacity layout of the
expert FFN, x (E, M, K) against stacked expert weights (E, K, N).  On a CUDA
tensor they launch the hand-written kernels of ``csrc/grouped_mlp.cu``
(built by ``kernels/build.py``): in bf16 both stream the weights through a
TMA ring into ``wgmma`` (``csrc/hopper.cuh``; ``grouped_swiglu`` streams w1
and w3 side by side, with silu(a) * b in the epilogue), in fp32 both run
the tile loop of ``csrc/ragged_tile.cuh``.  On a CPU tensor they compute
the plain version from ``kernels/ref.py``.  There is no other path: a
failed build or launch raises, and so does a launch under autograd on
operands that require grad (the kernels have no backward; training takes
the fused EP leg).
Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref

_VEC = 8          # K and N in multiples of one 16-byte vector of bf16
_INT_MAX = 2 ** 31 - 1


def _max_m(dtype: torch.dtype, E: int, N: int) -> int:
    """The largest M a route takes: the fp32 tile loop puts its 64-row M
    tiles on the grid's y axis (at most 65535 blocks); the bf16 stream
    counts its (expert, 128-column N panel, 64-row M tile) tiles in an int."""
    if dtype == torch.float32:
        return 64 * 65535
    return 64 * (_INT_MAX // max(1, E * -(-N // 128)))


def _check(x: torch.Tensor, ws: tuple) -> tuple[int, int, int, int]:
    """Shapes, types and devices both paths require; returns (E, M, K, N)."""
    if x.dim() != 3 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"expected x (E, M, K) and weights (E, K, N); got "
                         f"{tuple(x.shape)} and {[tuple(w.shape) for w in ws]}")
    E, M, K = x.shape
    N = ws[0].shape[2]
    for w in ws:
        if tuple(w.shape) != (E, K, N):
            raise ValueError(f"weight shape {tuple(w.shape)} does not match "
                             f"x {tuple(x.shape)} -> expected {(E, K, N)}")
        if w.dtype != x.dtype or w.device != x.device:
            raise ValueError(f"weights must share x's dtype and device "
                             f"({x.dtype}, {x.device}); got {w.dtype}, {w.device}")
    if x.dtype not in _cuda.SUFFIX:
        raise ValueError(f"unsupported dtype {x.dtype}; the kernels take "
                         f"{sorted(str(d) for d in _cuda.SUFFIX)}")
    return E, M, K, N


def _launch(wrapper, x: torch.Tensor, ws: tuple, dims) -> torch.Tensor:
    """Launch ``wrapper``'s kernel on x's current stream and count it."""
    op = wrapper.__name__
    E, M, K, N = dims
    _cuda.no_autograd(op, (x, *ws),
                      "the capacity-layout expert FFN is for serving; train "
                      "through the EP strategy's fused expert leg "
                      "(DistContext(moe_strategy='ep_shardmap', moe_fused=True)) "
                      "or its ragged one (moe_ragged=True)")
    max_m = _max_m(x.dtype, E, N)
    if K % _VEC or N % _VEC or M > max_m:
        raise ValueError(f"{op}: K={K} and N={N} must be multiples of {_VEC} "
                         f"and M={M} at most {max_m}")
    _cuda.operands(op, (x, *ws), x.dtype, x.device)
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    _cuda.launch("grouped_mlp", f"{op}_{_cuda.SUFFIX[x.dtype]}",
                 [x, *ws, out, E, M, K, N], x.device)
    wrapper.launches += 1
    return out


def grouped_swiglu(x: torch.Tensor, w1: torch.Tensor,
                   w3: torch.Tensor) -> torch.Tensor:
    """Fused silu(x @ w1) * (x @ w3) per expert: (E, M, K) -> (E, M, N)."""
    dims = _check(x, (w1, w3))
    if x.device.type == "cpu":
        return ref.grouped_swiglu_ref(x, w1, w3)
    return _launch(grouped_swiglu, x, (w1, w3), dims)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, M, K) @ w (E, K, N) -> (E, M, N), one expert per group."""
    dims = _check(x, (w,))
    if x.device.type == "cpu":
        return ref.grouped_matmul_ref(x, w)
    return _launch(grouped_matmul, x, (w,), dims)


grouped_swiglu.launches = 0
grouped_matmul.launches = 0
