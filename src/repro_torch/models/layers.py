"""Shared layer primitives: norms, RoPE, dense SwiGLU MLP."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm, computed in fp32 and cast back to x's type."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"]
    if "bias" in params:
        y = y + params["bias"]
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  Rotate-half RoPE in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                          # (hd/2,)
    ang = positions[..., None].float() * freqs                       # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
