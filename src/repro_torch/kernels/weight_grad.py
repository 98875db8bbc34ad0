"""The expert weights' gradient over the ragged layout: the CUDA kernel's
wrapper.

``segment_outer`` computes, for each expert e, the sum over its row blocks
of a_blockᵀ @ b_block (the weight-gradient step of the ragged and fused
legs' backward; the JAX package computes it with a ``lax.scan``,
``src/repro/kernels/ops.py:158`` ``_segment_outer``) and writes it into a
gradient buffer or adds it into what the buffer holds.  The add is how one
MoE layer keeps one gradient buffer per expert weight across its FCDA
chunks (``kernels/ops.py``).  On a CUDA tensor it launches its kernel of
``csrc/weight_grad.cu``, picked by dtype: bf16 a TMA + ``wgmma`` kernel
whose epilogue stages each output tile in shared memory and stores it by
TMA while the next tile's products run (adding, the old values are
TMA-loaded under the products too), fp32 a plain FMA tile loop.  On a CPU
tensor it computes the plain version of ``kernels/ref.py``.  It counts its kernel launches in ``.launches``.  The
bf16 kernel takes its output tile's rows of K at run time: the autotuner's
cached winner for (R, K, N, E, bm) where the kernel takes it (128 only when
K > 64), else 128, or 64 when K <= 64 (``kernels/tiling.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref
from repro_torch.kernels.tiling import resolve_tm


def tuned_row_tile(shape: tuple, dtype, tm=None) -> int:
    """The kernel's output-tile rows at ``shape`` (R, K, N, E, bm): 128, or
    64 when K <= 64; in bf16, ``tm`` if given, else the autotuner's cached
    winner, when the kernel takes it (64 always, 128 at K > 64)."""
    K = shape[1]
    default = 128 if K > 64 else 64
    if dtype != torch.bfloat16:
        return default
    return resolve_tm("segment_outer", shape, dtype, default,
                      (64, 128) if K > 64 else (64,), tm)


def segment_outer(a: torch.Tensor, b: torch.Tensor, block_to_expert: torch.Tensor,
                  total_rows, block_m: int, out: torch.Tensor, *,
                  accumulate: bool, tm=None) -> torch.Tensor:
    """a (R, K), b (R, N) bm-aligned expert-grouped rows -> out (E, K, N):
    out[e] (+)= the sum over the row blocks of expert e that start below
    ``total_rows`` of a_blockᵀ @ b_block, fp32 sums; with ``accumulate``
    the sum, cast to out's type, is added into out in fp32 and cast again
    (``ref.segment_outer_ref``).  The bf16 kernel's output tiles are 128
    rows of K, or 64 when K <= 64, unless ``tm`` or the tile cache says
    64.  Returns out."""
    R, K = a.shape
    E = out.shape[0]
    if b.dim() != 2 or b.shape[0] != R or out.shape != (E, K, b.shape[1]):
        raise ValueError(f"segment_outer: a {tuple(a.shape)}, b {tuple(b.shape)} and "
                         f"out {tuple(out.shape)} do not match (R, K), (R, N), (E, K, N)")
    if R % block_m or block_to_expert.shape != (R // block_m,):
        raise ValueError(f"segment_outer: R={R} rows must be {block_m}-row blocks, one "
                         f"block_to_expert entry each; got "
                         f"{tuple(block_to_expert.shape)}")
    if a.dtype != b.dtype or out.dtype != a.dtype:
        raise ValueError(f"segment_outer: a, b and out must share one dtype; got "
                         f"{a.dtype}, {b.dtype}, {out.dtype}")
    if a.device.type == "cpu":
        return ref.segment_outer_ref(a, b, block_to_expert, total_rows, out, accumulate)
    N = b.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"segment_outer: K={K} and N={N} must be multiples of 8")
    if a.dtype == torch.bfloat16 and block_m % 8:
        raise ValueError(f"segment_outer: the bf16 kernel loads rows in groups of 8; "
                         f"block_m={block_m} is not a multiple of 8")
    b2e = _cuda.index32(block_to_expert, a.device)
    _cuda.no_autograd("segment_outer", (a, b, out),
                      "train through kernels/ops.py (moe_ffn or ragged_expert_ffn)")
    _cuda.operands("segment_outer", (a, b, out, b2e), a.dtype, a.device)
    if out.numel() == 0:
        return out
    tm = tuned_row_tile((R, K, N, E, block_m), a.dtype, tm)
    _cuda.launch("weight_grad", f"segment_outer_{_cuda.SUFFIX[a.dtype]}",
                 [a, b, out, b2e, _cuda.total_rows_on(total_rows, a.device), R, K, N, E,
                  block_m, tm, int(accumulate)], a.device)
    segment_outer.launches += 1
    return out


segment_outer.launches = 0
