"""The expert FFN over dispatched capacity buffers, on the grouped kernels."""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped_mlp import grouped_matmul, grouped_swiglu


def expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU FFN over dispatched buffers.

    x: (..., E, C, d); w1, w3: (E, d, f); w2: (E, f, d) -> (..., E, C, d).

    The leading batch dims are folded into the row dim: x is permuted to
    (E, B*C, d), each kernel launches once, and the result is permuted back.
    Every output row is computed independently, so this is the function the
    JAX package computes with one launch per batch row, but each expert's
    weights are read once per call instead of once per row.
    """
    lead = x.shape[:-3]
    E, C, d = x.shape[-3:]
    xe = x.reshape(-1, E, C, d).transpose(0, 1).reshape(E, -1, d).contiguous()
    h = grouped_swiglu(xe, w1, w3)
    y = grouped_matmul(h, w2)
    return y.reshape(E, -1, C, d).transpose(0, 1).reshape(*lead, E, C, d)
