"""Ragged (MegaBlocks-style) grouped expert matmul: the CUDA kernel's wrapper.

``ragged_matmul`` multiplies expert-grouped rows by their expert's weight,
one expert per ``block_m``-row block (``block_to_expert``), and writes 0 at
and past ``total_rows``.  On a CUDA tensor it launches the kernel of
``csrc/ragged_mlp.cu``; on a CPU tensor it computes the plain version of
``kernels/ref.py``.  It counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref

_TILE_M = 64          # the kernel's row tile


def row_tile(block_m: int) -> int:
    """The kernel's rows per block: 64, or the whole row block when it is
    smaller, so a block's rows never straddle two experts."""
    if block_m % _TILE_M == 0:
        return _TILE_M
    if _TILE_M % block_m == 0:
        return block_m
    raise ValueError(f"block_m={block_m} must divide or be a multiple of {_TILE_M}")


def ragged_matmul(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                  total_rows, block_m: int, *, transpose_w: bool = False) -> torch.Tensor:
    """x: (R, K) bm-aligned expert-grouped rows; w: (E, K, N), or (E, N, K)
    used as its transpose when ``transpose_w`` -> (R, N) in x's type."""
    R, K = x.shape
    if w.dim() != 3 or w.shape[2 if transpose_w else 1] != K:
        raise ValueError(f"ragged_matmul: weights {tuple(w.shape)} do not match "
                         f"x {tuple(x.shape)} (transpose_w={transpose_w})")
    if R % block_m or block_to_expert.shape != (R // block_m,):
        raise ValueError(f"ragged_matmul: R={R} rows must be {block_m}-row "
                         f"blocks, one block_to_expert entry each; got "
                         f"{tuple(block_to_expert.shape)}")
    N = w.shape[1] if transpose_w else w.shape[2]
    if x.device.type == "cpu":
        return ref.ragged_matmul_ref(x, w.transpose(1, 2) if transpose_w else w,
                                     block_to_expert, total_rows)
    op = "ragged_matmul"
    if K % 8 or N % 8:
        raise ValueError(f"{op}: K={K} and N={N} must be multiples of 8")
    tm = row_tile(block_m)
    b2e = _cuda.index32(block_to_expert, x.device)
    _cuda.no_autograd(op, (x, w), "train through kernels/ops.py::moe_ffn")
    _cuda.operands(op, (x, w, b2e), x.dtype, x.device)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _cuda.launch("ragged_mlp", f"ragged_matmul_{_cuda.SUFFIX[x.dtype]}",
                 [x, w, out, b2e, _cuda.total_rows_on(total_rows, x.device),
                  R, K, N, block_m, tm, int(transpose_w)], x.device)
    ragged_matmul.launches += 1
    return out


ragged_matmul.launches = 0
