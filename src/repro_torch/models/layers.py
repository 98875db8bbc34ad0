"""Shared layer primitives: norms, RoPE (with YaRN's frequencies), dense
SwiGLU MLP."""

from __future__ import annotations

import math
from typing import Optional

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


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention-temperature factor 0.1 * mscale * ln(factor) + 1
    (1 at no scaling)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(head_dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """YaRN's (head_dim/2,) inverse frequencies (``yarn``: a ``YaRNSpec``):
    the dimensions that turn more than ``beta_fast`` times over the
    original context keep RoPE's frequency, those that turn fewer than
    ``beta_slow`` times are divided by ``factor``, with a linear ramp
    between, as DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding`` computes."""
    def dim_of(rotations):
        return (head_dim * math.log(yarn.original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    lo = max(math.floor(dim_of(yarn.beta_fast)), 0)
    hi = min(math.ceil(dim_of(yarn.beta_slow)), head_dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    extra = rope_freqs(head_dim, theta, device)
    return extra / yarn.factor * ramp + extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               inv_freq: Optional[torch.Tensor] = None,
               scale: float = 1.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  Rotate-half RoPE in fp32,
    at ``inv_freq`` (default RoPE's at ``theta``), cos and sin times
    ``scale`` (YaRN's mscale ratio)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device) if inv_freq is None else inv_freq
    ang = positions[..., None].float() * freqs                       # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]
