"""Ragged (MegaBlocks-style) grouped expert matmul and SwiGLU: the CUDA
kernels' wrappers.

``ragged_matmul`` multiplies expert-grouped rows by their expert's weight,
one expert per ``block_m``-row block (``block_to_expert``), and writes 0 at
and past ``total_rows``; ``ragged_swiglu`` computes silu(x @ w1[e]) *
(x @ w3[e]) over the same layout.  On a CUDA tensor each launches its
kernel of ``csrc/ragged_mlp.cu``, picked by dtype alone: in bf16 both run
the Hopper mainloop of ``csrc/ragged_wgmma.cuh`` (TMA, an mbarrier ring,
wgmma; ``ragged_matmul`` on 128- or 64-row tiles, ``ragged_swiglu`` on
128-row tiles of both weights), in fp32 the simple tile loop of
``csrc/ragged_tile.cuh``.  On a CPU tensor each computes the plain version
of ``kernels/ref.py``.  Each counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref

_TILE_M = 64          # the tile loop's row tile, and the Hopper kernel's small one


def row_tile(block_m: int, wide: bool = False) -> int:
    """The rows a kernel's tile keeps: 64, or the whole row block when it is
    smaller, so a tile's rows never straddle two experts.  ``wide`` (the
    bf16 kernels on ``csrc/ragged_wgmma.cuh``: ``ragged_matmul``,
    ``ragged_swiglu`` and ``fused_moe``): 128 when ``block_m`` is a multiple
    of 128, a 128-row tile holding one row block."""
    if block_m % _TILE_M == 0:
        return 2 * _TILE_M if wide and block_m % (2 * _TILE_M) == 0 else _TILE_M
    if _TILE_M % block_m == 0:
        return block_m
    raise ValueError(f"block_m={block_m} must divide or be a multiple of {_TILE_M}")


def _check_rows(op: str, x: torch.Tensor, block_to_expert: torch.Tensor,
                block_m: int) -> None:
    R = x.shape[0]
    if R % block_m or block_to_expert.shape != (R // block_m,):
        raise ValueError(f"{op}: R={R} rows must be {block_m}-row blocks, one "
                         f"block_to_expert entry each; got "
                         f"{tuple(block_to_expert.shape)}")


def _launch(op: str, x: torch.Tensor, weights: tuple, block_to_expert, total_rows,
            block_m: int, N: int, extra: tuple = ()) -> torch.Tensor:
    """Check the card's operands, launch ``op`` of ``csrc/ragged_mlp.cu`` and
    return its (R, N) output."""
    R, K = x.shape
    if K % 8 or N % 8:
        raise ValueError(f"{op}: K={K} and N={N} must be multiples of 8")
    tm = row_tile(block_m, wide=x.dtype == torch.bfloat16)
    b2e = _cuda.index32(block_to_expert, x.device)
    _cuda.no_autograd(op, (x, *weights),
                      "train through kernels/ops.py (moe_ffn or ragged_expert_ffn)")
    _cuda.operands(op, (x, *weights, b2e), x.dtype, x.device)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _cuda.launch("ragged_mlp", f"{op}_{_cuda.SUFFIX[x.dtype]}",
                 [x, *weights, out, b2e, _cuda.total_rows_on(total_rows, x.device),
                  R, K, N, block_m, tm, *extra], x.device)
    return out


def ragged_matmul(x: torch.Tensor, w: torch.Tensor, block_to_expert: torch.Tensor,
                  total_rows, block_m: int, *, transpose_w: bool = False) -> torch.Tensor:
    """x: (R, K) bm-aligned expert-grouped rows; w: (E, K, N), or (E, N, K)
    used as its transpose when ``transpose_w`` -> (R, N) in x's type."""
    K = x.shape[1]
    if w.dim() != 3 or w.shape[2 if transpose_w else 1] != K:
        raise ValueError(f"ragged_matmul: weights {tuple(w.shape)} do not match "
                         f"x {tuple(x.shape)} (transpose_w={transpose_w})")
    _check_rows("ragged_matmul", x, block_to_expert, block_m)
    if x.device.type == "cpu":
        return ref.ragged_matmul_ref(x, w.transpose(1, 2) if transpose_w else w,
                                     block_to_expert, total_rows)
    out = _launch("ragged_matmul", x, (w,), block_to_expert, total_rows, block_m,
                  w.shape[1] if transpose_w else w.shape[2],
                  (int(transpose_w), w.shape[0]))
    ragged_matmul.launches += 1
    return out


def ragged_swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  block_to_expert: torch.Tensor, total_rows,
                  block_m: int) -> torch.Tensor:
    """x: (R, K) bm-aligned expert-grouped rows; w1, w3: (E, K, N) ->
    silu(x @ w1[e]) * (x @ w3[e]) (R, N) in x's type, sums and silu in
    fp32."""
    K = x.shape[1]
    if w1.dim() != 3 or w1.shape[1] != K or w3.shape != w1.shape:
        raise ValueError(f"ragged_swiglu: weights {tuple(w1.shape)}, "
                         f"{tuple(w3.shape)} do not match x {tuple(x.shape)}")
    _check_rows("ragged_swiglu", x, block_to_expert, block_m)
    if x.device.type == "cpu":
        return ref.ragged_swiglu_ref(x, w1, w3, block_to_expert, total_rows)
    out = _launch("ragged_swiglu", x, (w1, w3), block_to_expert, total_rows, block_m,
                  w1.shape[2], (w1.shape[0],))
    ragged_swiglu.launches += 1
    return out


ragged_matmul.launches = 0
ragged_swiglu.launches = 0
