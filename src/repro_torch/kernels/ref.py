"""Plain PyTorch versions of the grouped expert-FFN kernels.

They are the CPU path of ``kernels/grouped_mlp.py`` and the reference the
CUDA kernels are held against on the card.  The arithmetic matches the JAX
package's ``kernels/ref.py``: products and sums in fp32 (JAX's
``preferred_element_type=float32``), the result cast to the input type, and
in the full FFN ``h`` is cast to the input type *before* the down-projection.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., E, M, K) @ (E, K, N) -> (..., E, M, N) in fp32."""
    return torch.matmul(x.float(), w.float())


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., E, M, K), w: (E, K, N) -> (..., E, M, N)."""
    return _mm_f32(x, w).to(x.dtype)


def grouped_swiglu_ref(x: torch.Tensor, w1: torch.Tensor,
                       w3: torch.Tensor) -> torch.Tensor:
    """silu(x @ w1) * (x @ w3), per expert group, silu in fp32."""
    return (F.silu(_mm_f32(x, w1)) * _mm_f32(x, w3)).to(x.dtype)


def expert_ffn_ref(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                   w2: torch.Tensor) -> torch.Tensor:
    """Full per-expert SwiGLU FFN: (..., E, C, d) -> (..., E, C, d)."""
    return grouped_matmul_ref(grouped_swiglu_ref(x, w1, w3), w2)
