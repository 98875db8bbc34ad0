"""Decoder-only transformer over LayerSpec patterns: init, the training
forward and prefill, decode.

Parameters are a plain dict: ``embed``, ``final_norm``, ``head`` (unless the
embeddings are tied) and ``layers``, one dict per layer in layer order.  The
JAX package stacks the layers of its scanned periods on a leading axis; the
port keeps them as a list (``bridge.params_from_jax`` unstacks).

A cache is {"pos": (B,) int64 positions, "layers": [per-layer caches]}.
``decode_step`` and ``extend_step`` update the cache tensors in place, the
positions included, and return the same dict: a CUDA graph captured over
them (``serving/engine.py``) reads and writes the same tensors at every
replay.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.moe import DistContext
from repro_torch.models import blocks
from repro_torch.models.layers import apply_norm


# ---------------------------------------------------------------------------
# init (the JAX package's shapes and scales; the numbers come from torch)
# ---------------------------------------------------------------------------

def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_layers or cfg.num_patch_tokens or cfg.learned_pos:
        raise NotImplementedError(f"{cfg.name!r}: encoder, patch and learned-"
                                  "position inputs are not ported yet")
    for spec in cfg.layer_specs():
        blocks._require_attn(spec)


def _init_layer(spec: LayerSpec, cfg: ModelConfig, normal, cut) -> dict:
    d, H, KH, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=normal.device)  # noqa: E731
    mixer = {"wq": normal((d, H * hd), d ** -0.5),
             "wk": normal((d, KH * hd), d ** -0.5),
             "wv": normal((d, KH * hd), d ** -0.5),
             "wo": normal((H * hd, d), (H * hd) ** -0.5)}
    if spec.attn.qk_norm:
        mixer["q_norm"] = {"scale": ones(hd)}
        mixer["k_norm"] = {"scale": ones(hd)}
    p = {"norm1": {"scale": ones(d)}, "mixer": mixer}
    if spec.ffn == "none":
        return p
    p["norm2"] = {"scale": ones(d)}
    if spec.ffn == "dense":
        f = cfg.d_ff
        p["ffn"] = {"w1": normal((d, f), d ** -0.5), "w3": normal((d, f), d ** -0.5),
                    "w2": normal((f, d), f ** -0.5)}
        return p
    moe = cfg.moe
    E, f = moe.num_experts, moe.d_ff_expert
    ffn = {"router": {"w": normal((d, E), d ** -0.5, torch.float32),
                      "bias": torch.zeros(E, dtype=torch.float32,
                                          device=normal.device)},
           "w1": cut(normal((E, d, f), d ** -0.5)),
           "w3": cut(normal((E, d, f), d ** -0.5)),
           "w2": cut(normal((E, f, d), f ** -0.5))}
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
    whole weight is freed as soon as it is cut."""
    _check_supported(cfg)
    normal = _Normal(seed, device, dtype)
    cut = ((lambda w: w) if mesh is None
           else (lambda w: mesh.local_experts(w).clone()))
    params = {"embed": normal((cfg.padded_vocab, cfg.d_model), 0.02),
              "final_norm": {"scale": torch.ones(cfg.d_model, device=normal.device)}}
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5)
    params["layers"] = [_init_layer(spec, cfg, normal, cut)
                        for spec in cfg.layer_specs()]
    return params


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    return params["embed"][batch["tokens"]]


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
    (``blocks.layer_ctx``)."""
    _check_supported(cfg)
    for name in ("layer_schedules", "placements"):
        vec = getattr(ctx, name)
        if vec is not None and len(vec) != num_moe_layers(cfg):
            raise ValueError(f"{name} has {len(vec)} entries, config {cfg.name!r} "
                             f"has {num_moe_layers(cfg)} MoE layers")
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
        out = blocks.apply_layer(layer_params, x, spec, cfg, lctx, positions, **kw)
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
               dtype, device) -> dict:
    _check_supported(cfg)
    return {"pos": torch.zeros(batch_size, dtype=torch.long, device=device),
            "layers": [blocks.init_layer_cache(spec, cfg, batch_size, seq_len,
                                               dtype, device)
                       for spec in cfg.layer_specs()]}


def decode_step(params: dict, cfg: ModelConfig, ctx: DistContext,
                cache: dict, tokens: torch.Tensor):
    """tokens: (B, 1) -> (logits (B, 1, V), cache).  Each row decodes at its
    own position ``cache["pos"][b]``."""
    pos = cache["pos"]
    x = params["embed"][tokens]
    for i, (layer_params, spec) in enumerate(zip(params["layers"],
                                                 cfg.layer_specs())):
        x, cache["layers"][i] = blocks.apply_layer_decode(
            layer_params, x, cache["layers"][i], spec, cfg, ctx, pos)
    pos.add_(1)          # in place: a captured step reads and writes this tensor
    return unembed(params, cfg, x), cache


def extend_step(params: dict, cfg: ModelConfig, ctx: DistContext,
                cache: dict, tokens: torch.Tensor):
    """tokens: (B, C) -> (logits (B, C, V), cache).  Multi-token cache
    extension, the chunked-prefill continuation: each chunk attends over
    the cache so far plus itself, then its K/V joins the cache."""
    pos0 = cache["pos"]
    x = params["embed"][tokens]
    for i, (layer_params, spec) in enumerate(zip(params["layers"],
                                                 cfg.layer_specs())):
        x, cache["layers"][i] = blocks.apply_layer_extend(
            layer_params, x, cache["layers"][i], spec, cfg, ctx, pos0)
    pos0.add_(tokens.shape[1])
    return unembed(params, cfg, x), cache
