"""One transformer layer: mixer (attention | Mamba-2) + FFN (dense | MoE | none).

The training forward and the serving forms of a layer: the forward and the
cache-building prefill (``apply_layer``), single-token decode
(``apply_layer_decode``) and C-token cache extension
(``apply_layer_extend``).  Decode and extension carry one position per batch
row (``pos``: (B,) int), so every row of a batch -- every slot of the
serving scheduler's pool -- has its own RoPE positions, ring write cursor
and valid length.  They write the new K/V, or a mamba layer's new state and
conv tail (``models/ssm.py``), into the cache tensors in place: a CUDA
graph captured over the cache reads and writes the same tensors at every
replay.  A masked decode keeps the cache of the rows outside its mask bit
for bit, every leaf of it.

An encoder-decoder layer (``"cross"`` in its params) attends, after its
mixer, over the encoder's output: the training forward and the prefill
project it into K/V, and the prefill and ``init_layer_cache`` store them as
the layer cache's ``cross_k`` and ``cross_v``, written once and only read by
decode and extension afterwards.

Attention runs against the cache in the cache's type (the serving pool is
fp32 whatever the weights' type); its output is cast back to the
activations' type before the output projection, so the residual stream
keeps the weights' type.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.chunking import ScheduleSpec
from repro_torch.core.moe import DistContext, moe_ffn
from repro_torch.models import ssm as ssm_mod
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


# ---------------------------------------------------------------------------
# attention mixer
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::qkv_proj", mutates_args=())
def qkv_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for one of the attention mixer's q, k and v projections under
    autograd at ``remat_policy="selective"``: an operator of its own, so
    that the policy can save its output (``apply_layer``).  ``qkv_proj.runs`` counts the
    products it computed; a saved one is not computed again."""
    qkv_proj.runs += 1
    return x @ w


qkv_proj.runs = 0


def _qkv_proj_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _qkv_proj_backward(ctx, g):
    x, w = ctx.saved_tensors
    gw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ g.reshape(-1, g.shape[-1])
    return g @ w.transpose(0, 1), gw


torch.library.register_autograd("repro_torch::qkv_proj", _qkv_proj_backward,
                                setup_context=_qkv_proj_context)


REMAT_POLICIES = ("none", "full", "memfine", "selective")
# the "selective" policy: save the q, k and v projections, recompute the rest
_SAVE_QKV = functools.partial(create_selective_checkpoint_contexts,
                              [torch.ops.repro_torch.qkv_proj.default])


def _project(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x @ w; under autograd at ``remat_policy="selective"``, through
    ``qkv_proj``, whose output that policy saves."""
    if cfg.remat_policy == "selective" and torch.is_grad_enabled():
        return qkv_proj(x, w)
    return x @ w


def _qkv_base(p: dict, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
              positions: torch.Tensor):
    """Projections + qk-norm + RoPE, KV still at KH heads (the cache layout).
    positions: (B, S) int."""
    B, S, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _project(x, p["wq"], cfg).reshape(B, S, H, hd)
    k = _project(x, p["wk"], cfg).reshape(B, S, KH, hd)
    v = _project(x, p["wv"], cfg).reshape(B, S, KH, hd)
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
                      cfg: ModelConfig, spec: LayerSpec, ctx: DistContext,
                      mask: Optional[torch.Tensor] = None):
    """x: (B, 1, d); cache {"k","v"}: (B, Sc, KH, hd); pos: (B,) int.
    ``mask`` ((B,) bool): only its rows write their new K/V; the others
    write back the row they hold (a masked subset wave)."""
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
    for name, new in (("k", k), ("v", v)):
        new = new[:, 0].to(cache[name].dtype)
        if mask is not None:
            new = torch.where(mask[:, None, None], new, cache[name][rows, write])
        cache[name][rows, write] = new
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


def chunk_write_slots(spec: LayerSpec, Sc: int, pos0: torch.Tensor,
                      C: int) -> torch.Tensor:
    """(B, min(C, Sc)) cache slots a C-token chunk at per-row positions
    ``pos0`` writes, in the order of its last min(C, Sc) tokens (a ring
    keeps only the last Sc tokens of a chunk that wraps it whole)."""
    if _is_ring(spec, Sc):
        n = min(C, Sc)
        first = pos0 + C - n
        return (first[:, None] + torch.arange(n, device=pos0.device)) % Sc
    if C > Sc:
        raise ValueError(f"a {C}-token chunk does not fit the {Sc}-slot "
                         f"linear cache")
    return torch.clamp(pos0, max=Sc - C)[:, None] + torch.arange(C, device=pos0.device)


def write_attn_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                     pos0: torch.Tensor, spec: LayerSpec) -> dict:
    """Write a C-token chunk starting at per-row positions ``pos0`` ((B,))
    into the cache in place, ring or linear."""
    B, C = k.shape[:2]
    idx = chunk_write_slots(spec, cache["k"].shape[1], pos0, C)
    n = idx.shape[1]
    rows = torch.arange(B, device=k.device)[:, None]
    cache["k"][rows, idx] = k[:, C - n:].to(cache["k"].dtype)
    cache["v"][rows, idx] = v[:, C - n:].to(cache["v"].dtype)
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
# mamba mixer state
# ---------------------------------------------------------------------------

def write_state(cache: dict, state: dict,
                mask: Optional[torch.Tensor] = None) -> None:
    """Copy a mamba layer's new ``state`` into its cache tensors in place,
    in the cache's type; with ``mask`` ((B,) bool) only its rows, the
    others keeping every bit."""
    for name, new in state.items():
        new = new.to(cache[name].dtype)
        if mask is not None:
            keep = mask.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, cache[name])
        cache[name].copy_(new)


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


def _cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder output's (B, Se, KH, hd) cross-attention K and V."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (enc_out @ p["wk"]).reshape(shape), (enc_out @ p["wv"]).reshape(shape)


def _cross_q(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = h.shape
    return (h @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.resolved_head_dim)


def _cross_prefill(params: dict, x: torch.Tensor, enc_out: torch.Tensor,
                   spec: LayerSpec, cfg: ModelConfig):
    """Cross-attention residual of the forward: (x, (K, V)), non-causal
    over every encoder row (no qk-norm, no RoPE)."""
    h = apply_norm(params["norm_x"], x, cfg.norm)
    k, v = _cross_kv(params["cross"], enc_out, cfg)
    o = attention(_cross_q(params["cross"], h, cfg), k, v, spec.attn, causal=False)
    return x + _out_proj(params["cross"], o, x), (k, v)


def _cross_cached(params: dict, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention residual of decode and extension, against the
    cache's ``cross_k`` and ``cross_v``, which it only reads: every query
    row sees every encoder row."""
    h = apply_norm(params["norm_x"], x, cfg.norm)
    q = _cross_q(params["cross"], h, cfg)
    k, v = cache["cross_k"], cache["cross_v"]
    B, C, Se = x.shape[0], x.shape[1], k.shape[1]
    if C == 1:
        out = decode_attention(q, k, v, torch.full((B,), Se, device=x.device))
    else:
        out = extend_attention(q, k, v, torch.ones((B, C, Se), dtype=torch.bool,
                                                   device=x.device))
    return x + _out_proj(params["cross"], out, x)


def apply_layer(params: dict, x: torch.Tensor, spec: LayerSpec,
                cfg: ModelConfig, ctx: DistContext, positions: torch.Tensor, *,
                causal: bool = True, enc_out: Optional[torch.Tensor] = None,
                cache_len: Optional[int] = None, cache_dtype=None):
    """Train/prefill.  Returns (x, stats), or (x, stats, cache) when
    ``cache_len`` is given: the single-pass prefill builds the layer's decode
    cache from the K/V this pass computes.

    Under autograd without a cache, ``remat_policy`` "full" or "memfine"
    wraps the layer in a non-reentrant checkpoint (Megatron full
    recomputation); the MoE's per-chunk checkpoints nest inside it, as the
    JAX package's nested ``jax.checkpoint``s do.  "selective" checkpoints
    it under a selective policy that saves the attention mixer's q, k and
    v, as the JAX package's ``save_only_these_names("qkv")`` does: the
    saved tensors are the three projections' outputs (``qkv_proj``), so the
    backward's recompute does not run the projections again; RoPE and the
    qk-norm, elementwise, are recomputed from them.  (PyTorch's policy
    re-runs every operator it does not save, so saving q, k and v after
    RoPE, where the JAX package names them, would still re-run the
    projections that XLA drops as dead code.)  A mamba layer's cache is
    its SSD state after the prompt and the prompt's last w-1 conv inputs;
    an encoder-decoder layer's also holds the cross K/V of ``enc_out``."""
    cross = "cross" in params and enc_out is not None
    if cache_len is not None:
        h = apply_norm(params["norm1"], x, cfg.norm)
        dtype = cache_dtype or x.dtype
        if spec.mixer == "attn":
            h, (k, v) = attn_mixer(params["mixer"], h, cfg, spec, positions, ctx,
                                   causal, return_kv=True)
            cache = {"attn": build_attn_cache(k, v, spec, cache_len, dtype)}
        else:
            h, state = ssm_mod.apply_ssm(params["mixer"], h, spec.ssm,
                                         return_state=True)
            cache = {"ssm": {n: t.to(dtype) for n, t in state.items()}}
        x = x + h
        if cross:
            x, (k, v) = _cross_prefill(params, x, enc_out, spec, cfg)
            cache["cross_k"], cache["cross_v"] = k.to(dtype), v.to(dtype)
        x, stats = _ffn(params, x, spec, cfg, ctx)
        return x, stats if stats is not None else zero_stats(cfg, x.device), cache

    def layer_fn(x):
        h = apply_norm(params["norm1"], x, cfg.norm)
        if spec.mixer == "attn":
            h = attn_mixer(params["mixer"], h, cfg, spec, positions, ctx, causal)
        else:
            h = ssm_mod.apply_ssm(params["mixer"], h, spec.ssm)
        x = x + h
        if cross:
            x = _cross_prefill(params, x, enc_out, spec, cfg)[0]
        x, stats = _ffn(params, x, spec, cfg, ctx)
        return x, stats if stats is not None else zero_stats(cfg, x.device)

    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: the port implements "
                         f"{REMAT_POLICIES}")
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return layer_fn(x)
    if cfg.remat_policy == "selective":
        return checkpoint(layer_fn, x, use_reentrant=False, context_fn=_SAVE_QKV)
    return checkpoint(layer_fn, x, use_reentrant=False)



def _row_load(stats: Optional[dict], cfg: ModelConfig, x: torch.Tensor):
    """The layer's (B, E) routed load per batch row; zeros for a dense or
    absent FFN."""
    if stats is None:
        E = cfg.moe.num_experts if cfg.moe is not None else 1
        return torch.zeros((x.shape[0], E), dtype=torch.float32, device=x.device)
    if "row_load" not in stats:
        raise ValueError("per-row loads come from the local and dense MoE "
                         "strategies; the EP path does not report them")
    return stats["row_load"]


def apply_layer_decode(params: dict, x: torch.Tensor, cache: dict,
                       spec: LayerSpec, cfg: ModelConfig, ctx: DistContext,
                       pos: torch.Tensor, *, mask: Optional[torch.Tensor] = None,
                       return_load: bool = False):
    """Single-token decode; x: (B, 1, d), pos: (B,).  Returns (x, cache),
    or (x, cache, (B, E) routed load per row) with ``return_load``: the
    JAX package's (E,) load of a one-slot step, for every slot at once.
    ``mask`` ((B,) bool) writes the cache of its rows only."""
    h = apply_norm(params["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        h, cache["attn"] = attn_mixer_decode(params["mixer"], h, cache["attn"],
                                             pos, cfg, spec, ctx, mask)
    else:
        h, state = ssm_mod.decode_ssm(params["mixer"], h, cache["ssm"], spec.ssm)
        write_state(cache["ssm"], state, mask)
    x = x + h
    if "cross" in params and "cross_k" in cache:
        x = _cross_cached(params, x, cache, cfg)
    x, stats = _ffn(params, x, spec, cfg, ctx)
    if return_load:
        return x, cache, _row_load(stats, cfg, x)
    return x, cache


def apply_layer_extend(params: dict, x: torch.Tensor, cache: dict,
                       spec: LayerSpec, cfg: ModelConfig, ctx: DistContext,
                       pos0: torch.Tensor, *, return_load: bool = False):
    """C-token cache extension (chunked prefill); x: (B, C, d) at per-row
    positions pos0..pos0+C-1.  Returns (x, cache), or (x, cache, (B, E)
    routed load per row) with ``return_load``.  A mamba layer continues
    each row from its own state, whatever its position."""
    h = apply_norm(params["norm1"], x, cfg.norm)
    if spec.mixer == "attn":
        h, cache["attn"] = attn_mixer_extend(params["mixer"], h, cache["attn"],
                                             pos0, cfg, spec, ctx)
    else:
        h, state = ssm_mod.apply_ssm(params["mixer"], h, spec.ssm,
                                     return_state=True,
                                     initial_state=cache["ssm"])
        write_state(cache["ssm"], state)
    x = x + h
    if "cross" in params and "cross_k" in cache:
        x = _cross_cached(params, x, cache, cfg)
    x, stats = _ffn(params, x, spec, cfg, ctx)
    if return_load:
        return x, cache, _row_load(stats, cfg, x)
    return x, cache


def init_layer_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     seq_len: int, dtype, device,
                     enc_out: Optional[torch.Tensor] = None,
                     cross_params: Optional[dict] = None) -> dict:
    """Decode cache for one layer (window layers ring-bounded; a mamba
    layer's state and conv tail, whatever the length).  With ``enc_out``
    and an encoder-decoder layer's ``cross_params``, also the cross K/V of
    ``enc_out``, as computed (the reference keeps their type too)."""
    if spec.mixer != "attn":
        cache = {"ssm": ssm_mod.init_state(batch, cfg.d_model, spec.ssm, dtype,
                                           device)}
    else:
        Sc = cache_len(spec, seq_len)
        shape = (batch, Sc, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache = {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}}
    if cross_params is not None and enc_out is not None:
        cache["cross_k"], cache["cross_v"] = _cross_kv(cross_params, enc_out, cfg)
    return cache
