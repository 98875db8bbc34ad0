"""MemFine's memory model (paper section 3, Table 2, Eq. 1-3, 8-9).

The port's copy of the JAX package's ``core/memory_model.py``, formula for
formula: the training half that MACT inverts, and the serving form that
admission uses.  Notation follows the paper's Table 1: s sequence length,
s' tokens received by the MoE layer per device, h hidden size, a heads, h_d
head dim, k_a kv heads, e_n experts, g_d dense-FFN and g_e expert-FFN
widths, t/p/c/e/d tensor/pipeline/context/expert/data parallel sizes, b
micro batch, v virtual stages.

Training (Eq. 2):

    M_act = m_g/(t*c) * D_t*b * [ s*(5h + a*h_d + 2*k_a*h_d + e_n)
                                  + s'*(2h + 2*g_e) ]

FCDA divides the s' term by the chunk count c (with ``pipeline_depth``
chunks live at once: s' * min(depth, c)/c); the fused expert leg drops its
2h dispatch-buffer half.  Eq. (8) inverts the model for the largest
admissible s', Eq. (9) gives the chunk count c = ceil(depth * s''/s'_max).

Serving: the scheduler admits a request only when

    M_weights + (n+1) * M_cache(L) + max(M_act_decode, M_act_prefill)
        <= alpha * M_GPU                                   (Eq. 3, serving)

with M_act's MoE term at the dropless structural worst case s' = e_n * tokens
(every expert's capacity is the whole chunk).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import HardwareProfile, ModelConfig


@dataclass(frozen=True)
class Parallelism:
    """Paper Table 1 parallelism sizes (Megatron-style)."""
    t: int = 1      # tensor
    p: int = 1      # pipeline
    c: int = 1      # context
    e: int = 1      # expert
    d: int = 1      # data
    b: int = 1      # micro batch
    v: int = 1      # virtual pipeline stages per GPU


@dataclass(frozen=True)
class LayerDims:
    """Table 1 model dims for one transformer layer."""
    h: int
    a: int
    h_d: int
    k_a: int
    e_n: int
    g_d: int
    g_e: int
    topk: int = 1

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "LayerDims":
        moe = cfg.moe
        return cls(h=cfg.d_model, a=cfg.num_heads, h_d=cfg.resolved_head_dim,
                   k_a=cfg.num_kv_heads, e_n=moe.num_experts if moe else 0,
                   g_d=cfg.d_ff, g_e=moe.d_ff_expert if moe else 0,
                   topk=moe.top_k if moe else 1)


def shared_act_bytes(dims: LayerDims, s: int, par: Parallelism,
                     dtype_bytes: int = 2) -> float:
    """The sequence-proportional (attention + router) term of Table 2."""
    per_tok = 5 * dims.h + dims.a * dims.h_d + 2 * dims.k_a * dims.h_d + dims.e_n
    return dtype_bytes * par.b * s * per_tok / (par.t * par.c)


def m_g(par: Parallelism, r_pp: int = 0, full_recompute: bool = False) -> int:
    """Number of stored layer-activation copies (paper section 3)."""
    if full_recompute:
        return 1
    return max(1, par.v * par.p + par.p - 2 * r_pp - 1)


def _moe_per_token(dims: LayerDims, fused: bool) -> float:
    """Per-received-token MoE activation width (Table 2's 2h + 2g_e).  The
    2h half is the (R, d) dispatch buffer's round trip, which the fused
    expert leg never builds, so under ``fused`` only the 2g_e backward
    recompute transient remains."""
    return (0 if fused else 2 * dims.h) + 2 * dims.g_e


def moe_act_bytes(dims: LayerDims, s_prime: float, par: Parallelism,
                  dtype_bytes: int = 2, *, fused: bool = False) -> float:
    """The received-token-proportional MoE term of Table 2."""
    return (dtype_bytes * par.b * s_prime * _moe_per_token(dims, fused)
            / (par.t * par.c))


def activation_bytes(dims: LayerDims, s: int, s_prime: float, par: Parallelism,
                     *, copies: int = 1, chunks: int = 1,
                     dtype_bytes: int = 2, pipeline_depth: int = 1,
                     fused: bool = False) -> float:
    """Eq. (2) peak activation, with FCDA chunking dividing the MoE term
    and ``min(pipeline_depth, chunks)`` chunks live at once."""
    shared = shared_act_bytes(dims, s, par, dtype_bytes)
    live = min(max(pipeline_depth, 1), chunks)
    moe = moe_act_bytes(dims, s_prime, par, dtype_bytes,
                        fused=fused) * live / chunks
    return copies * (shared + moe)


def worst_case_s_prime(s: int, par: Parallelism, topk: int = 1) -> int:
    """Theoretical peak received tokens: every token-slot in the EP group
    lands on one device (paper section 3: s' approaches e*s; with top-k
    slots, e*s*k)."""
    return par.e * par.b * s * topk


#: bytes of training state per parameter the model charges, Megatron-style
#: BF16 mixed precision: bf16 weight (2) + fp32 grad (4) + fp32 master (4)
#: + Adam m, v (8)
TRAIN_STATE_BYTES = 18


#: serving static memory is weight-only: bf16 weights, no grads or optimizer
WEIGHT_ONLY_BYTES = 2


def _ssm_dims(d_model: int, spec):
    d_in = spec.expand * d_model
    return d_in, d_in // spec.head_dim, d_in + 2 * spec.state_dim


def param_counts(cfg: ModelConfig, par: Parallelism) -> dict[str, float]:
    """Per-GPU parameter counts by module group (Eq. 1's S_i^para)."""
    h = cfg.d_model
    hd = cfg.resolved_head_dim
    counts: dict[str, float] = {}
    counts["embed"] = cfg.vocab_size * h / par.t
    counts["lm_head"] = 0.0 if cfg.tie_embeddings else cfg.vocab_size * h / par.t
    attn = dense_ffn = moe_experts = moe_shared = router = mamba = norms = 0.0
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            q = h * cfg.num_heads * hd
            kv = 2 * h * cfg.num_kv_heads * hd
            o = cfg.num_heads * hd * h
            attn += (q + kv + o) / par.t
        elif spec.mixer == "mamba":
            d_in = spec.ssm.expand * h
            nheads = d_in // spec.ssm.head_dim
            in_proj = h * (2 * d_in + 2 * spec.ssm.state_dim * nheads + nheads)
            out_proj = d_in * h
            conv = spec.ssm.conv_width * (d_in + 2 * spec.ssm.state_dim * nheads)
            mamba += (in_proj + out_proj + conv + 3 * nheads) / par.t
        if spec.ffn == "dense":
            dense_ffn += 3 * h * cfg.d_ff / par.t
        elif spec.ffn == "moe":
            moe = cfg.moe
            local_experts = max(1, moe.num_experts // par.e)
            moe_experts += local_experts * 3 * h * moe.d_ff_expert / par.t
            moe_shared += moe.num_shared_experts * 3 * h * moe.d_ff_expert / par.t
            router += h * moe.num_experts
        norms += 2 * h
    if cfg.encoder_layers:
        q = h * cfg.num_heads * hd
        kv = 2 * h * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * h
        attn += cfg.encoder_layers * (q + kv + o) / par.t
        dense_ffn += cfg.encoder_layers * 3 * h * cfg.d_ff / par.t
        attn += cfg.num_layers * (q + kv + o) / par.t
    counts.update(attn=attn, dense_ffn=dense_ffn, moe_experts=moe_experts,
                  moe_shared=moe_shared, router=router, mamba=mamba, norms=norms)
    return counts


def static_bytes(cfg: ModelConfig, par: Parallelism,
                 bytes_per_param: float = TRAIN_STATE_BYTES,
                 per_stage: bool = True) -> float:
    """Eq. (1): per-device static memory.  ``per_stage`` divides layer
    params by the pipeline size (embedding counted on the first stage)."""
    counts = param_counts(cfg, par)
    layer_params = sum(v for k, v in counts.items() if k not in ("embed", "lm_head"))
    if per_stage:
        layer_params /= par.p
    return (counts["embed"] + layer_params) * bytes_per_param


def total_params(cfg: ModelConfig) -> float:
    """Global parameter count N."""
    return sum(param_counts(cfg, Parallelism()).values())


# ---------------------------------------------------------------------------
# MACT equations (Eq. 3, 8, 9)
# ---------------------------------------------------------------------------

def fits(static: float, act: float, hw: HardwareProfile) -> bool:
    """Eq. (3): M_sta + M_act <= alpha * M_GPU."""
    return static + act <= hw.alpha * hw.hbm_bytes


def replica_weight_bytes(cfg: ModelConfig, extra_slots_per_peer: int,
                         par: Parallelism,
                         bytes_per_param: float = WEIGHT_ONLY_BYTES) -> float:
    """Per-device weight bytes of hot-expert replica slots (0 without
    placement): weight-only, as the JAX package prices them; the slot
    copies of a rank's other experts and their gradients are not priced."""
    if cfg.moe is None or extra_slots_per_peer <= 0:
        return 0.0
    n_moe = sum(1 for spec in cfg.layer_specs() if spec.ffn == "moe")
    per_slot = 3 * cfg.d_model * cfg.moe.d_ff_expert / par.t
    return extra_slots_per_peer * per_slot * bytes_per_param * n_moe / par.p


def s_prime_max(dims: LayerDims, s: int, par: Parallelism, hw: HardwareProfile,
                static: float, *, copies: int = 1, dtype_bytes: int = 2,
                fused: bool = False, replica_bytes: float = 0.0) -> float:
    """Eq. (8): the largest per-device received-token count that fits."""
    budget = (hw.alpha * hw.hbm_bytes - static - replica_bytes
              - copies * shared_act_bytes(dims, s, par, dtype_bytes))
    denom = (copies * dtype_bytes * par.b * _moe_per_token(dims, fused)
             / (par.t * par.c))
    return budget / denom


def optimal_chunks(s_pp: float, s_max: float, pipeline_depth: int = 1) -> int:
    """Eq. (9): c = ceil(depth * s'' / s'_max), never fewer than ``depth``
    chunks; a sentinel large value when even one token cannot fit."""
    if s_max <= 0:
        return 1 << 30
    return max(pipeline_depth, 1, math.ceil(pipeline_depth * s_pp / s_max))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def expert_weight_bytes(cfg: ModelConfig,
                        dtype_bytes: float = WEIGHT_ONLY_BYTES) -> float:
    """Weight bytes of ONE routed expert in ONE MoE layer (3 * h * g_e)."""
    if cfg.moe is None:
        return 0.0
    return 3 * cfg.d_model * cfg.moe.d_ff_expert * dtype_bytes


def serve_weight_bytes(cfg: ModelConfig,
                       dtype_bytes: float = WEIGHT_ONLY_BYTES, *,
                       resident_experts: Optional[int] = None) -> float:
    """Serving static memory: Eq. (1) with weight-only bytes per param, all
    stages resident; ``resident_experts`` of E experts per MoE layer on the
    device when given."""
    total = total_params(cfg) * dtype_bytes
    if resident_experts is None or cfg.moe is None:
        return total
    E = cfg.moe.num_experts
    r = min(max(int(resident_experts), 0), E)
    n_moe = sum(1 for spec in cfg.layer_specs() if spec.ffn == "moe")
    return total - (E - r) * expert_weight_bytes(cfg, dtype_bytes) * n_moe


def decode_cache_bytes(cfg: ModelConfig, cache_len: int,
                       dtype_bytes: int = 2) -> float:
    """Per-request decode-cache bytes: KV at k_a * h_d per token per
    attention layer (ring-bounded by the window), SSM state + conv tail for
    mamba layers, cross K/V for encoder-decoder archs."""
    total = 0.0
    kv_row = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            Sc = cache_len
            if spec.attn.kind in ("window", "chunked") and spec.attn.window:
                Sc = min(spec.attn.window, cache_len)
            total += Sc * kv_row
        else:
            d_in, heads, d_conv = _ssm_dims(cfg.d_model, spec.ssm)
            total += heads * spec.ssm.head_dim * spec.ssm.state_dim
            total += (spec.ssm.conv_width - 1) * d_conv
        if cfg.encoder_layers:
            total += cfg.encoder_seq * kv_row
    return total * dtype_bytes


def serve_act_bytes(dims: LayerDims, tokens: int, cfg: Optional[ModelConfig] = None,
                    dtype_bytes: int = 2) -> float:
    """Live activations for one serving wave of ``tokens`` tokens: the
    Eq. (2) per-layer term at a single copy, plus the fp32 logits, with the
    MoE term at the dropless structural worst case s' = e_n * tokens."""
    if tokens <= 0:
        return 0.0
    par = Parallelism()
    act = shared_act_bytes(dims, tokens, par, dtype_bytes)
    if dims.g_e:
        act += moe_act_bytes(dims, dims.e_n * tokens, par, dtype_bytes)
    if cfg is not None:
        act += tokens * cfg.padded_vocab * 4
    return act


def serving_peak_bytes(cfg: ModelConfig, *, requests: int, cache_len: int,
                       decode_tokens: int, prefill_tokens: int = 0,
                       dtype_bytes: int = 2,
                       weight_bytes: float = WEIGHT_ONLY_BYTES,
                       replica_weight_bytes: float = 0.0,
                       resident_experts: Optional[int] = None,
                       prefetch_experts: int = 0) -> float:
    """Modeled peak serving memory with ``requests`` admitted requests:
    weights + per-request caches + the worse of the decode wave (one token
    per occupied slot, so clamped to ``requests``) and the prefill chunk."""
    dims = LayerDims.from_config(cfg)
    act = max(serve_act_bytes(dims, min(decode_tokens, requests), cfg,
                              dtype_bytes),
              serve_act_bytes(dims, prefill_tokens, cfg, dtype_bytes))
    return (serve_weight_bytes(cfg, weight_bytes,
                               resident_experts=resident_experts)
            + prefetch_experts * expert_weight_bytes(cfg, weight_bytes)
            + replica_weight_bytes
            + requests * decode_cache_bytes(cfg, cache_len, dtype_bytes)
            + act)


def serving_fits(cfg: ModelConfig, hw: HardwareProfile, **kw) -> bool:
    """Eq. (3) for serving: admit only when the modeled peak fits."""
    return serving_peak_bytes(cfg, **kw) <= hw.alpha * hw.hbm_bytes
