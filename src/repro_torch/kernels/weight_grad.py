"""The expert weights' gradient over the ragged layout: the CUDA kernel's
wrapper.

``segment_outer`` computes, for each expert e, the sum over its row blocks
of a_blockᵀ @ b_block (the weight-gradient step of the ragged and fused
legs' backward; the JAX package computes it with a ``lax.scan``,
``src/repro/kernels/ops.py:158`` ``_segment_outer``) and writes it into a
gradient buffer or adds it into what the buffer holds.  The add is how one
MoE layer keeps one gradient buffer per expert weight across its FCDA
chunks (``kernels/ops.py``).  On a CUDA tensor it launches its kernel of
``csrc/weight_grad.cu``, picked by dtype: bf16 a TMA + ``wgmma`` kernel,
fp32 a plain FMA tile loop.  On a CPU tensor it computes the plain version
of ``kernels/ref.py``.  It counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda, ref


def segment_outer(a: torch.Tensor, b: torch.Tensor, block_to_expert: torch.Tensor,
                  total_rows, block_m: int, out: torch.Tensor, *,
                  accumulate: bool) -> torch.Tensor:
    """a (R, K), b (R, N) bm-aligned expert-grouped rows -> out (E, K, N):
    out[e] (+)= the sum over the row blocks of expert e that start below
    ``total_rows`` of a_blockᵀ @ b_block, fp32 sums; with ``accumulate``
    the sum, cast to out's type, is added into out in fp32 and cast again
    (``ref.segment_outer_ref``).  The bf16 kernel's output tiles are 128
    rows of K, or 64 when K <= 64.  Returns out."""
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
    _cuda.launch("weight_grad", f"segment_outer_{_cuda.SUFFIX[a.dtype]}",
                 [a, b, out, b2e, _cuda.total_rows_on(total_rows, a.device), R, K, N, E,
                  block_m, 128 if K > 64 else 64, int(accumulate)], a.device)
    segment_outer.launches += 1
    return out


segment_outer.launches = 0
