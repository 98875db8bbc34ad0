"""Blocked attention in plain PyTorch matmuls.

The JAX package has no kernel on this path, so neither does the port (and it
does not use ``scaled_dot_product_attention``).  Scores and softmax are fp32
(JAX's ``preferred_element_type=float32``); the probabilities are cast to
V's type before the value product.

* prefill: static query blocks; a window layer's block i attends the kv
  band [i*qb - W, (i+1)*qb) -- O(S*W) work.
* extend: a C-token chunk against cached + own K/V under a per-row
  position mask (ring layout included).
* decode: one token against the cache under a per-row length mask.

GQA: prefill repeats KV up to H heads; extend and decode use the grouped
(KH, G) form, which needs no cache-sized repeat.  Prefill takes a value
head of its own width (MLA's 128 beside its 192-wide query and key heads)
and a given softmax scale (MLA's, with YaRN's temperature).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionSpec

NEG_INF = -1e30
#: prefill's query block (``attention``); the memory model reads it too
BLOCK_Q = 1024


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KH, hd) -> (B, S, H, hd) by repeating each KV head H/KH times."""
    KH = k.shape[2]
    if KH == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // KH, dim=2)


def _block_attend(q, k, v, mask, scale):
    """q: (B, Sq, H, hd), k/v: (B, Skv, H, hd), mask: (Sq, Skv) or None."""
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def _causal_mask(sq: int, skv: int, q_start: int, kv_start: int,
                 window: int = 0, device=None) -> torch.Tensor:
    qpos = q_start + torch.arange(sq, device=device)[:, None]
    kpos = kv_start + torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: AttentionSpec, *, causal: bool = True,
              block_q: int = BLOCK_Q, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k: (B, S, KH, hd); v: (B, S, KH, hv) -> (B, S, H, hv).
    ``scale`` defaults to hd^-0.5."""
    B, S, H, hd = q.shape
    hv = v.shape[-1]
    scale = hd ** -0.5 if scale is None else scale
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    dev = q.device

    if spec.kind == "chunked" and causal and S > spec.window:
        C = spec.window
        if S % C:
            raise ValueError(f"sequence {S} is not a multiple of chunk {C}")
        n = S // C
        mask = _causal_mask(C, C, 0, 0, device=dev)
        fold = lambda t: t.reshape(B * n, C, H, t.shape[-1])  # noqa: E731
        return _block_attend(fold(q), fold(k), fold(v), mask,
                             scale).reshape(B, S, H, hv)

    if not causal:
        return _block_attend(q, k, v, None, scale)

    qb = min(block_q, S)
    if S % qb:
        raise ValueError(f"sequence {S} is not a multiple of block {qb}")
    window = spec.window if spec.kind == "window" else 0
    outs = []
    for i in range(S // qb):
        q_start = i * qb
        lo = max(0, (q_start - window) // qb * qb) if window else 0
        hi = q_start + qb
        mask = _causal_mask(qb, hi - lo, q_start, lo, window, device=dev)
        outs.append(_block_attend(q[:, q_start:hi], k[:, lo:hi], v[:, lo:hi],
                                  mask, scale))
    return torch.cat(outs, dim=1)


def extend_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Cache-extension attention: a C-token chunk against cached + own K/V.

    q: (B, C, H, hd); k, v: (B, Skv, KH, hd) pre-repeat; mask: (B, C, Skv)
    bool, which key slots each row's queries may see."""
    B, C, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, C, KH, G, hd)
    s = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k.float()) * hd ** -0.5
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgcs,bskd->bckgd", p, v)
    return out.reshape(B, C, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode.  q: (B, 1, H, hd); caches: (B, Sc, KH, hd);
    lengths: (B,) number of valid cache entries per row."""
    B, _, H, hd = q.shape
    Sc, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * hd ** -0.5
    valid = torch.arange(Sc, device=q.device)[None] < lengths[:, None]   # (B, Sc)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache)
    return out.reshape(B, 1, H, hd)
