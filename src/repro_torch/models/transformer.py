"""Decoder and encoder-decoder stack over LayerSpec patterns (attention and
Mamba-2 mixers, dense, MoE or no FFN): init, the training forward and
prefill, decode.

Parameters are a plain dict: ``embed``, ``final_norm``, ``head`` (unless the
embeddings are tied), ``pos_embed`` (learned positions), ``layers``, one
dict per layer in layer order, and for an encoder-decoder config
``encoder``: {"layers": [...], "final_norm", "pos_embed"}.  The JAX package
stacks the layers of its scanned periods and its encoder on a leading
axis; the port keeps them as lists (``bridge.params_from_jax`` unstacks).

Inputs beside the tokens, as in the JAX package: a VLM's ``patches`` (B,
n_patch, d) take the first positions of the sequence, ahead of the token
embeddings; an audio model's ``frames`` (B, encoder_seq, d) go through the
encoder (``encode``), whose output every decoder layer cross-attends.  The
conv frontend and the vision tower are stubs in both packages: the frames
and patches arrive as embeddings.

A cache is {"pos": (B,) int64 positions, "layers": [per-layer caches]}.
``decode_step`` and ``extend_step`` update the cache tensors in place, the
positions included, and return the same dict: a CUDA graph captured over
them (``serving/engine.py``) reads and writes the same tensors at every
replay.  A learned position embedding is read per row at the row's own
position (clamped to the table), where the reference reads one position for
the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig
from repro_torch.core.moe import DistContext
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_norm

# every encoder layer: bidirectional attention without RoPE, a dense FFN
_ENC_SPEC = LayerSpec(mixer="attn", ffn="dense",
                      attn=AttentionSpec(kind="full", rope=False))


# ---------------------------------------------------------------------------
# init (the JAX package's shapes and scales; the numbers come from torch)
# ---------------------------------------------------------------------------

def _norm(n: int, kind: str, device) -> dict:
    """A norm's fp32 parameters: a unit scale, and for LayerNorm a zero
    bias."""
    p = {"scale": torch.ones(n, dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(n, dtype=torch.float32, device=device)
    return p


def _init_attention(normal, cfg: ModelConfig, qk_norm: bool = False) -> dict:
    d, H, KH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {"wq": normal((d, H * hd), d ** -0.5),
         "wk": normal((d, KH * hd), d ** -0.5),
         "wv": normal((d, KH * hd), d ** -0.5),
         "wo": normal((H * hd, d), (H * hd) ** -0.5)}
    if qk_norm:
        p["q_norm"] = _norm(hd, "rmsnorm", normal.device)
        p["k_norm"] = _norm(hd, "rmsnorm", normal.device)
    return p


def _init_mla(normal, cfg: ModelConfig) -> dict:
    """MLA's leaves, in the order of its equations (``blocks.mla_mixer``):
    the query latent's projection, norm and up-projection, the key/value
    latent's (with the shared RoPE key part) and its norm and
    up-projection, the output projection."""
    d, H, m = cfg.d_model, cfg.num_heads, cfg.mla
    qr, kvr = m.q_lora_rank, m.kv_lora_rank
    return {"wq_a": normal((d, qr), d ** -0.5),
            "q_a_norm": _norm(qr, "rmsnorm", normal.device),
            "wq_b": normal((qr, H * m.qk_head_dim), qr ** -0.5),
            "wkv_a": normal((d, kvr + m.qk_rope_head_dim), d ** -0.5),
            "kv_a_norm": _norm(kvr, "rmsnorm", normal.device),
            "wkv_b": normal((kvr, H * (m.qk_nope_head_dim + m.v_head_dim)), kvr ** -0.5),
            "wo": normal((H * m.v_head_dim, d), (H * m.v_head_dim) ** -0.5)}


def _init_layer(spec: LayerSpec, cfg: ModelConfig, normal, cut,
                cross: bool = False) -> dict:
    d = cfg.d_model
    norm = lambda: _norm(d, cfg.norm, normal.device)  # noqa: E731
    if spec.mixer == "attn" and cfg.mla is not None:
        mixer = _init_mla(normal, cfg)
    elif spec.mixer == "attn":
        mixer = _init_attention(normal, cfg, spec.attn.qk_norm)
    else:
        mixer = ssm_mod.init_ssm(normal, d, spec.ssm)
    p = {"norm1": norm(), "mixer": mixer}
    if cross:
        p["norm_x"] = norm()
        p["cross"] = _init_attention(normal, cfg)
    if spec.ffn == "none":
        return p
    p["norm2"] = norm()
    if spec.ffn == "dense":
        f = cfg.d_ff
        p["ffn"] = {"w1": normal((d, f), d ** -0.5), "w3": normal((d, f), d ** -0.5),
                    "w2": normal((f, d), f ** -0.5)}
        return p
    moe = cfg.moe
    E, f, held = moe.num_experts, moe.d_ff_expert, moe.held
    ffn = {"router": {"w": normal((d, E), d ** -0.5, torch.float32),
                      "bias": torch.zeros(E, dtype=torch.float32,
                                          device=normal.device)},
           "w1": cut(normal((held, d, f), d ** -0.5)),
           "w3": cut(normal((held, d, f), d ** -0.5)),
           "w2": cut(normal((held, f, d), f ** -0.5))}
    if moe.num_shared_experts:
        fs = moe.num_shared_experts * f
        ffn["shared"] = {"w1": normal((d, fs), d ** -0.5),
                         "w3": normal((d, fs), d ** -0.5),
                         "w2": normal((fs, d), f ** -0.5)}
    p["ffn"] = ffn
    return p


class _Normal:
    """Scaled standard normals from one seeded generator on one device."""

    def __init__(self, seed: int, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def __call__(self, shape, scale: float, dtype=None) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=dtype or self.dtype)
        return t.mul_(scale)


def init_params(cfg: ModelConfig, *, device, dtype=torch.float32,
                seed: int = 0, mesh=None) -> dict:
    """Random weights with the JAX init's shapes and scales: matrices in
    ``dtype``, norm scales and the router in fp32.  Under a mesh
    (``launch/mesh.py``) each expert weight keeps only this rank's E / P
    experts, cut from the same draw as the one-rank init makes, and the
    whole weight is freed as soon as it is cut.  A config that holds a share
    of its experts (``MoEConfig.experts_held``) makes only those: the router
    keeps all E outputs.  An encoder-decoder
    config's decoder layers carry ``norm_x`` and ``cross``, and its encoder
    ``encoder_layers`` layers of ``_ENC_SPEC``."""
    normal = _Normal(seed, device, dtype)
    dev = normal.device
    cut = ((lambda w: w) if mesh is None
           else (lambda w: mesh.local_experts(w).clone()))
    params = {"embed": normal((cfg.padded_vocab, cfg.d_model), 0.02),
              "final_norm": _norm(cfg.d_model, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5)
    if cfg.learned_pos:
        params["pos_embed"] = normal((cfg.learned_pos, cfg.d_model), 0.02)
    cross = cfg.encoder_layers > 0
    params["layers"] = [_init_layer(spec, cfg, normal, cut, cross)
                        for spec in cfg.layer_specs()]
    if cross:
        params["encoder"] = {
            "layers": [_init_layer(_ENC_SPEC, cfg, normal, cut)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": _norm(cfg.d_model, cfg.norm, dev),
            "pos_embed": normal((cfg.encoder_seq, cfg.d_model), 0.02)}
    return params


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Token embeddings, after the patch embeddings where the config takes
    them, plus the learned positions 0..S-1 where it has them."""
    x = params["embed"][batch["tokens"]]
    if cfg.num_patch_tokens and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    if cfg.learned_pos:
        x = x + params["pos_embed"][:x.shape[1]]
    return x


def _embed_at(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Embeddings of (B, C) tokens at per-row positions pos..pos+C-1: the
    learned position of each, clamped to the table's last row."""
    x = params["embed"][tokens]
    if cfg.learned_pos:
        idx = pos[:, None] + torch.arange(tokens.shape[1], device=pos.device)
        x = x + params["pos_embed"][idx.clamp(max=cfg.learned_pos - 1)]
    return x.to(params["embed"].dtype)


# ---------------------------------------------------------------------------
# encoder: frames are the conv frontend's output embeddings (a stub in both
# packages)
# ---------------------------------------------------------------------------

def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           ctx: DistContext) -> torch.Tensor:
    """(B, encoder_seq, d) frames -> the encoder's normed output."""
    enc = params["encoder"]
    x = frames.to(enc["pos_embed"].dtype) + enc["pos_embed"]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for layer_params in enc["layers"]:
        x, _ = blocks.apply_layer(layer_params, x, _ENC_SPEC, cfg, ctx, positions,
                                  causal=False)
    return apply_norm(enc["final_norm"], x, cfg.norm)


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head; logits in fp32."""
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ head).float()


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def num_moe_layers(cfg: ModelConfig) -> int:
    """The length of the per-layer schedule and placement vectors and of
    the ``load_per_layer`` matrix's leading axis."""
    return sum(1 for s in cfg.layer_specs() if s.ffn == "moe")


def forward(params: dict, cfg: ModelConfig, ctx: DistContext, batch: dict, *,
            return_cache: bool = False, cache_len: Optional[int] = None,
            cache_dtype=torch.float32):
    """Returns (logits (B, S, V) fp32, stats), or (logits, stats, cache) with
    ``return_cache``: the single-pass serving prefill, every layer's decode
    cache laid out as ``init_cache`` + token-by-token decode would leave it.
    ``cache_len`` sizes the caches (default: the prompt length).

    ``stats`` sums the MoE stats over layers and carries ``load_per_layer``,
    the (L_moe, E) routed-load matrix in layer order: the telemetry of
    adaptive MACT and expert placement.  ``ctx.layer_schedules`` (one
    ScheduleSpec per MoE layer) and ``ctx.placements`` (one PlacementSpec
    per MoE layer) give each MoE layer its own schedule and placement
    (``blocks.layer_ctx``).  An encoder-decoder config first encodes the
    batch's ``frames``, and every layer cross-attends the encoder's output."""
    for name in ("layer_schedules", "placements"):
        vec = getattr(ctx, name)
        if vec is not None and len(vec) != num_moe_layers(cfg):
            raise ValueError(f"{name} has {len(vec)} entries, config {cfg.name!r} "
                             f"has {num_moe_layers(cfg)} MoE layers")
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(params, cfg, batch["frames"], ctx)
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    kw = {}
    if return_cache:
        kw = {"cache_len": cache_len if cache_len is not None else S,
              "cache_dtype": cache_dtype}
    stats = blocks.zero_stats(cfg, x.device)
    loads, caches = [], []
    for layer_params, spec in zip(params["layers"], cfg.layer_specs()):
        # an MoE layer's own schedule and placement; its position among the
        # MoE layers is the number of loads gathered so far
        lctx = blocks.layer_ctx(ctx, len(loads) if spec.ffn == "moe" else None)
        out = blocks.apply_layer(layer_params, x, spec, cfg, lctx, positions,
                                 enc_out=enc_out, **kw)
        x, st = out[0], out[1]
        if return_cache:
            caches.append(out[2])
        stats = {k: stats[k] + st[k] for k in stats}
        if spec.ffn == "moe":
            loads.append(st["load"])
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        stats["load_per_layer"] = (torch.stack(loads) if loads
                                   else torch.zeros((0, E), device=x.device))
    logits = unembed(params, cfg, x)
    if return_cache:
        pos = torch.full((B,), S, dtype=torch.long, device=x.device)
        return logits, stats, {"pos": pos, "layers": caches}
    return logits, stats


# ---------------------------------------------------------------------------
# decode and cache extension
# ---------------------------------------------------------------------------

def init_cache(params: dict, cfg: ModelConfig, batch_size: int, seq_len: int,
               dtype, device, enc_out: Optional[torch.Tensor] = None) -> dict:
    """An empty decode cache; with ``enc_out`` (B, Se, d), each
    encoder-decoder layer's cross K/V projected from it."""
    return {"pos": torch.zeros(batch_size, dtype=torch.long, device=device),
            "layers": [blocks.init_layer_cache(spec, cfg, batch_size, seq_len,
                                               dtype, device, enc_out=enc_out,
                                               cross_params=layer.get("cross"))
                       for spec, layer in zip(cfg.layer_specs(), params["layers"])]}


def _load_matrix(loads: list, cfg: ModelConfig, x: torch.Tensor,
                 per_row: bool) -> torch.Tensor:
    """The MoE layers' (B, E) row loads as (B, L_moe, E) with ``per_row``,
    else summed over rows to ``forward``'s (L_moe, E) ``load_per_layer``."""
    if loads:
        rows = torch.stack(loads, dim=1)
    else:
        E = cfg.moe.num_experts if cfg.moe is not None else 1
        rows = torch.zeros((x.shape[0], 0, E), dtype=torch.float32, device=x.device)
    return rows if per_row else rows.sum(0)


def decode_step(params: dict, cfg: ModelConfig, ctx: DistContext,
                cache: dict, tokens: torch.Tensor, *, return_load: bool = False,
                per_row: bool = False, mask: Optional[torch.Tensor] = None):
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  Each row decodes at its
    own position ``cache["pos"][b]``.

    ``return_load`` appends the (L_moe, E) routed-load matrix in
    ``forward``'s ``load_per_layer`` order, or with ``per_row`` the
    (B, L_moe, E) one of each row: the telemetry of expert-aware serving.
    ``mask`` ((B,) bool) makes a masked subset wave: only its rows write
    their cache row and advance their position; every row still computes,
    and each row's logits do not depend on the others'.  The default path
    is the one without the flags."""
    pos = cache["pos"]
    x = _embed_at(params, cfg, tokens, pos)
    loads = []
    for i, (layer_params, spec) in enumerate(zip(params["layers"],
                                                 cfg.layer_specs())):
        out = blocks.apply_layer_decode(
            layer_params, x, cache["layers"][i], spec, cfg, ctx, pos,
            mask=mask, return_load=return_load)
        x, cache["layers"][i] = out[0], out[1]
        if return_load and spec.ffn == "moe":
            loads.append(out[2])
    # in place: a captured step reads and writes this tensor
    pos.add_(1 if mask is None else mask.to(pos.dtype))
    logits = unembed(params, cfg, x)
    if return_load:
        return logits, cache, _load_matrix(loads, cfg, x, per_row)
    return logits, cache


def extend_step(params: dict, cfg: ModelConfig, ctx: DistContext,
                cache: dict, tokens: torch.Tensor, *, return_load: bool = False):
    """tokens: (B, C) -> (logits (B, C, V), cache).  Multi-token cache
    extension, the chunked-prefill continuation: each chunk attends over
    the cache so far plus itself, then its K/V joins the cache.
    ``return_load`` appends the (L_moe, E) routed-load matrix, as in
    ``decode_step``."""
    pos0 = cache["pos"]
    x = _embed_at(params, cfg, tokens, pos0)
    loads = []
    for i, (layer_params, spec) in enumerate(zip(params["layers"],
                                                 cfg.layer_specs())):
        out = blocks.apply_layer_extend(
            layer_params, x, cache["layers"][i], spec, cfg, ctx, pos0,
            return_load=return_load)
        x, cache["layers"][i] = out[0], out[1]
        if return_load and spec.ffn == "moe":
            loads.append(out[2])
    pos0.add_(tokens.shape[1])
    logits = unembed(params, cfg, x)
    if return_load:
        return logits, cache, _load_matrix(loads, cfg, x, per_row=False)
    return logits, cache
