"""One transformer layer: attention mixer + FFN (dense | MoE | none).

The training forward and the serving forms of a layer: the forward and the
cache-building prefill (``apply_layer``), single-token decode
(``apply_layer_decode``) and C-token cache extension
(``apply_layer_extend``).  Decode and extension carry one position per batch
row (``pos``: (B,) int), so every row of a batch -- every slot of the
serving scheduler's pool -- has its own RoPE positions, ring write cursor
and valid length.  They write the new K/V into the cache tensors in place.

Attention runs against the cache in the cache's type (the serving pool is
fp32 whatever the weights' type); its output is cast back to the
activations' type before the output projection, so the residual stream
keeps the weights' type.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.chunking import ScheduleSpec
from repro_torch.core.moe import DistContext, moe_ffn
from repro_torch.models.attention import (attention, decode_attention,
                                          extend_attention)
from repro_torch.models.layers import apply_mlp, apply_norm, apply_rope


def zero_stats(cfg: ModelConfig, device) -> dict:
    E = cfg.moe.num_experts if cfg.moe else 1
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux_loss": z, "load": torch.zeros(E, device=device), "drops": z}


def layer_ctx(ctx: DistContext, moe_index: Optional[int]) -> DistContext:
    """The context the MoE layer at MoE position ``moe_index`` runs under.
    With a schedule vector (``ctx.layer_schedules``, adaptive MACT) the
    layer gets its own (chunk bin, pipeline depth), and with a placement
    vector (``ctx.placements``) its own expert placement; otherwise the
    global knobs apply.  The returned context drops the vectors, so the
    layer sees only the knobs it always did."""
    if moe_index is None or (ctx.layer_schedules is None and ctx.placements is None):
        return ctx
    changes: dict = {}
    if ctx.layer_schedules is not None:
        spec = ScheduleSpec(*ctx.layer_schedules[moe_index])
        changes.update(moe_chunks=spec.chunks, pipeline_chunks=spec.depth,
                       layer_schedules=None)
    if ctx.placements is not None:
        changes.update(placement=ctx.placements[moe_index], placements=None)
    return dataclasses.replace(ctx, **changes)


def _require_attn(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(f"{spec.mixer!r} mixers are not ported yet")


# ---------------------------------------------------------------------------
# attention mixer
# ---------------------------------------------------------------------------

def _qkv_base(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
              positions: torch.Tensor):
    """Projections + qk-norm + RoPE, KV still at KH heads (the cache layout).
    positions: (B, S) int."""
    B, S, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KH, hd)
    v = (x @ p["wv"]).reshape(B, S, KH, hd)
    if "q_norm" in p:
        q = apply_norm(p["q_norm"], q)
        k = apply_norm(p["k_norm"], k)
    if spec.attn.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return out.reshape(B, S, -1).to(x.dtype) @ p["wo"]


def attn_mixer(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
               positions: torch.Tensor, ctx: DistContext, causal: bool = True,
               return_kv: bool = False):
    """Prefill attention.  ``return_kv`` also returns the pre-repeat
    (B, S, KH, hd) K/V that the single-pass prefill writes into the cache."""
    q, k, v = _qkv_base(p, x, cfg, spec, positions)
    y = _out_proj(p, attention(q, k, v, spec.attn, causal=causal), x)
    return (y, (k, v)) if return_kv else y


def cache_len(spec: LayerSpec, seq_len: int) -> int:
    if spec.attn.kind in ("window", "chunked") and spec.attn.window:
        return min(spec.attn.window, seq_len)
    return seq_len


def _is_ring(spec: LayerSpec, num_slots: int) -> bool:
    """The decode path rings exactly when the cache is window-sized."""
    return (spec.attn.kind in ("window", "chunked") and bool(spec.attn.window)
            and num_slots == spec.attn.window)


def attn_mixer_decode(p: dict, x: torch.Tensor, cache: dict, pos: torch.Tensor,
                      cfg: ModelConfig, spec: LayerSpec, ctx: DistContext):
    """x: (B, 1, d); cache {"k","v"}: (B, Sc, KH, hd); pos: (B,) int."""
    B = x.shape[0]
    q, k, v = _qkv_base(p, x, cfg, spec, pos[:, None])
    Sc = cache["k"].shape[1]
    if _is_ring(spec, Sc):
        write = pos % Sc
        if spec.attn.kind == "window":
            length = torch.clamp(pos + 1, max=Sc)
        else:
            length = pos % Sc + 1                 # chunk-local context
    else:
        # a linear cache's write is clamped to its last slot, as the JAX
        # package's dynamic_update_slice clamps it (only idle pool slots,
        # which decode on past their request, ever get there)
        write = torch.clamp(pos, max=Sc - 1)
        length = pos + 1
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, write] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, write] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], length)
    return _out_proj(p, out, x), cache


def slot_positions(spec: LayerSpec, num_slots: int,
                   filled: torch.Tensor) -> torch.Tensor:
    """(B, num_slots) token position held by each cache slot after ``filled``
    ((B,) int) writes, -1 = never written.  Linear caches hold position i at
    slot i; ring caches the newest position p < filled with
    p % num_slots == i."""
    i = torch.arange(num_slots, device=filled.device)[None]
    f = filled[:, None]
    if _is_ring(spec, num_slots):
        pos = i + torch.div(f - 1 - i, num_slots, rounding_mode="floor") * num_slots
    else:
        pos = i.expand(f.shape[0], -1)
    return torch.where(i < f, torch.maximum(pos, i), -1)


def build_attn_cache(k: torch.Tensor, v: torch.Tensor, spec: LayerSpec,
                     total_len: int, dtype) -> dict:
    """Lay a prompt's (B, S, KH, hd) K/V out as the decode cache the
    token-by-token replay would have produced: linear caches get the prompt
    at slots 0..S-1, ring caches the last ``window`` tokens at slots p % W."""
    B, S = k.shape[:2]
    Sc = cache_len(spec, total_len)
    ring = _is_ring(spec, Sc)
    if S > Sc and not ring:
        raise ValueError(f"prompt length {S} exceeds the {Sc}-slot linear "
                         f"cache (cache_len={total_len})")

    def lay(t):
        t = t.to(dtype)
        if ring and S >= Sc:
            return torch.roll(t[:, S - Sc:], (S - Sc) % Sc, dims=1)
        buf = t.new_zeros((B, Sc) + t.shape[2:])
        buf[:, :S] = t
        return buf

    return {"k": lay(k), "v": lay(v)}


def write_attn_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                     pos0: torch.Tensor, spec: LayerSpec) -> dict:
    """Write a C-token chunk starting at per-row positions ``pos0`` ((B,))
    into the cache in place, ring or linear."""
    B, C = k.shape[:2]
    Sc = cache["k"].shape[1]
    if _is_ring(spec, Sc):
        if C >= Sc:           # only the last Sc tokens survive a full wrap
            k, v, pos0, C = k[:, C - Sc:], v[:, C - Sc:], pos0 + C - Sc, Sc
        idx = (pos0[:, None] + torch.arange(C, device=k.device)) % Sc
    else:
        if C > Sc:
            raise ValueError(f"a {C}-token chunk does not fit the {Sc}-slot "
                             f"linear cache")
        idx = torch.clamp(pos0, max=Sc - C)[:, None] + torch.arange(C, device=k.device)
    rows = torch.arange(B, device=k.device)[:, None]
    cache["k"][rows, idx] = k.to(cache["k"].dtype)
    cache["v"][rows, idx] = v.to(cache["v"].dtype)
    return cache


def gather_paged_tokens(pool: torch.Tensor, table: torch.Tensor,
                        token_axis: int, length: int) -> torch.Tensor:
    """A dense token cache assembled from page-pool rows.

    ``pool``: (P, *page_shape) with ``page_shape[token_axis]`` the page
    size; ``table``: (..., n_blocks) integer page ids (page 0 is the zero
    page, so never-filled blocks read as the zero-initialised cache).
    Returns (..., *dense_shape): the token axis merged to
    ``n_blocks * page`` and cut to ``length`` (a ragged layout pads its
    last page)."""
    lead = table.dim() - 1
    x = pool[table.long()]                    # (..., n_blocks, *page_shape)
    a = lead + token_axis
    x = torch.movedim(x, lead, a)             # block axis beside its page axis
    sh = x.shape
    x = x.reshape(sh[:a] + (sh[a] * sh[a + 1],) + sh[a + 2:])
    return x.narrow(a, 0, length)


def scatter_paged_tokens(pool: torch.Tensor, table: torch.Tensor,
                         dense: torch.Tensor, token_axis: int,
                         page: int) -> torch.Tensor:
    """The inverse of ``gather_paged_tokens``, in place: split a dense token
    cache into page rows and write them at ``table``'s ids of ``pool``;
    returns ``pool``.  A ragged token axis is zero-padded into the last
    page's tail (never gathered back).  Duplicate ids write in no set
    order, which is harmless: CoW-shared pages gathered by several slots
    carry bit-identical rows, and the scratch page (id 1) takes the writes
    of unallocated blocks and empty slots, which nothing reads."""
    lead = table.dim() - 1
    a = lead + token_axis
    nb = table.shape[-1]
    pad = nb * page - dense.shape[a]
    if pad:
        sh = list(dense.shape)
        sh[a] = pad
        dense = torch.cat([dense, dense.new_zeros(sh)], dim=a)
    sh = dense.shape
    dense = dense.reshape(sh[:a] + (nb, page) + sh[a + 1:])
    dense = torch.movedim(dense, a, lead)     # (..., n_blocks, *page_shape)
    pool.index_put_((table.long(),), dense.to(pool.dtype))
    return pool


def _extend_mask(spec: LayerSpec, key_pos: torch.Tensor,
                 q_pos: torch.Tensor) -> torch.Tensor:
    """(B, C, Skv) visibility: causal over key *positions* (-1 = empty slot),
    window-banded or chunk-local per the attention kind.
    key_pos: (B, Skv); q_pos: (B, C)."""
    kp, qp = key_pos[:, None, :], q_pos[:, :, None]
    m = (kp >= 0) & (kp <= qp)
    W = spec.attn.window
    if spec.attn.kind == "window" and W:
        m &= kp > qp - W
    elif spec.attn.kind == "chunked" and W:
        m &= (torch.div(kp, W, rounding_mode="floor")
              == torch.div(qp, W, rounding_mode="floor"))
    return m


def attn_mixer_extend(p: dict, x: torch.Tensor, cache: dict, pos0: torch.Tensor,
                      cfg: ModelConfig, spec: LayerSpec, ctx: DistContext):
    """x: (B, C, d) chunk at positions pos0..pos0+C-1 per row.  Attends over
    the cache-before-this-chunk plus the chunk's own K/V (so ring overwrites
    within the chunk cannot clobber still-visible keys), then writes the
    chunk into the cache."""
    C = x.shape[1]
    positions = pos0[:, None] + torch.arange(C, device=x.device)
    q, k, v = _qkv_base(p, x, cfg, spec, positions)
    Sc = cache["k"].shape[1]
    key_pos = torch.cat([slot_positions(spec, Sc, pos0), positions], dim=1)
    mask = _extend_mask(spec, key_pos, positions)
    k_cat = torch.cat([cache["k"], k.to(cache["k"].dtype)], dim=1)
    v_cat = torch.cat([cache["v"], v.to(cache["v"].dtype)], dim=1)
    out = extend_attention(q, k_cat, v_cat, mask)
    return _out_proj(p, out, x), write_attn_cache(cache, k, v, pos0, spec)


# ---------------------------------------------------------------------------
# whole layer
# ---------------------------------------------------------------------------

def _ffn(params: dict, x: torch.Tensor, spec: LayerSpec, cfg: ModelConfig,
         ctx: DistContext):
    """Pre-norm FFN residual; returns (x, stats or None)."""
    if spec.ffn == "none":
        return x, None
    h = apply_norm(params["norm2"], x, cfg.norm)
    if spec.ffn == "dense":
        return x + apply_mlp(params["ffn"], h), None
    h, stats = moe_ffn(params["ffn"], h, cfg.moe, ctx)
    return x + h, stats


def apply_layer(params: dict, x: torch.Tensor, spec: LayerSpec,
                cfg: ModelConfig, ctx: DistContext, positions: torch.Tensor, *,
                causal: bool = True, cache_len: Optional[int] = None,
                cache_dtype=None):
    """Train/prefill.  Returns (x, stats), or (x, stats, cache) when
    ``cache_len`` is given: the single-pass prefill builds the layer's decode
    cache from the K/V this pass computes.

    Under autograd without a cache, ``remat_policy`` "full" or "memfine"
    wraps the layer in a non-reentrant checkpoint (Megatron full
    recomputation); the MoE's per-chunk checkpoints nest inside it, as the
    JAX package's nested ``jax.checkpoint``s do."""
    _require_attn(spec)
    if cache_len is not None:
        h = apply_norm(params["norm1"], x, cfg.norm)
        h, (k, v) = attn_mixer(params["mixer"], h, cfg, spec, positions, ctx,
                               causal, return_kv=True)
        cache = {"attn": build_attn_cache(k, v, spec, cache_len,
                                          cache_dtype or x.dtype)}
        x, stats = _ffn(params, x + h, spec, cfg, ctx)
        return x, stats if stats is not None else zero_stats(cfg, x.device), cache

    def layer_fn(x):
        h = apply_norm(params["norm1"], x, cfg.norm)
        h = attn_mixer(params["mixer"], h, cfg, spec, positions, ctx, causal)
        x, stats = _ffn(params, x + h, spec, cfg, ctx)
        return x, stats if stats is not None else zero_stats(cfg, x.device)

    if cfg.remat_policy in ("full", "memfine") and torch.is_grad_enabled():
        return checkpoint(layer_fn, x, use_reentrant=False)
    return layer_fn(x)


def apply_layer_decode(params: dict, x: torch.Tensor, cache: dict,
                       spec: LayerSpec, cfg: ModelConfig, ctx: DistContext,
                       pos: torch.Tensor):
    """Single-token decode; x: (B, 1, d), pos: (B,).  Returns (x, cache)."""
    _require_attn(spec)
    h = apply_norm(params["norm1"], x, cfg.norm)
    h, cache["attn"] = attn_mixer_decode(params["mixer"], h, cache["attn"],
                                         pos, cfg, spec, ctx)
    x, _ = _ffn(params, x + h, spec, cfg, ctx)
    return x, cache


def apply_layer_extend(params: dict, x: torch.Tensor, cache: dict,
                       spec: LayerSpec, cfg: ModelConfig, ctx: DistContext,
                       pos0: torch.Tensor):
    """C-token cache extension (chunked prefill); x: (B, C, d) at per-row
    positions pos0..pos0+C-1.  Returns (x, cache)."""
    _require_attn(spec)
    h = apply_norm(params["norm1"], x, cfg.norm)
    h, cache["attn"] = attn_mixer_extend(params["mixer"], h, cache["attn"],
                                         pos0, cfg, spec, ctx)
    x, _ = _ffn(params, x + h, spec, cfg, ctx)
    return x, cache


def init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     seq_len: int, dtype, device) -> dict:
    """Decode cache for one layer (window layers ring-bounded)."""
    _require_attn(spec)
    Sc = cache_len(spec, seq_len)
    shape = (batch, Sc, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}
