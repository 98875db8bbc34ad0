"""DeepSeek-V3's architecture as the benchmark reads it (arXiv:2412.19437):
multi-head latent attention in every layer, leading dense SwiGLU layers,
then MoE layers of a grouped sigmoid router over 256 SwiGLU experts and one
shared expert, RMSNorm, an untied LM head.  The chip holds a share of each
MoE layer's experts (``n_routed_experts`` of the file: the experts held
here; the router's width is the published count).

The functions are those ``arch/mixtral.py`` describes.  DeepSeek-V3's own
keys of the shape dict: ``d_model``, ``n_heads``, ``q_lora_rank``,
``kv_lora_rank``, ``qk_nope``, ``qk_rope``, ``v_head`` (MLA's widths),
``vocab`` (the embedding's rows, padded to a multiple of 256), ``d_ff``
(the dense layers), ``d_ff_expert``, ``n_shared``, ``scoring``, ``n_group``,
``topk_group``, ``routed_scaling``, ``aux_coef``, ``bias_rate``,
``rope_theta``, ``yarn`` (factor, original_max_position, beta_fast,
beta_slow, mscale, mscale_all_dim) and ``eps``.
"""

from __future__ import annotations

from perfbench.spec import pad256
from perfbench.work import causal_visible, least_s

_YARN = ("factor", "original_max_position", "beta_fast", "beta_slow", "mscale",
         "mscale_all_dim")


def spec_from_file(cfg: dict) -> dict:
    """The shapes a configuration file states, as run."""
    dense = int(cfg["first_k_dense_replace"])
    rs = cfg["rope_scaling"]
    yarn = (rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
            rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
    return {
        "d_model": int(cfg["hidden_size"]), "n_heads": int(cfg["num_attention_heads"]),
        "q_lora_rank": int(cfg["q_lora_rank"]), "kv_lora_rank": int(cfg["kv_lora_rank"]),
        "qk_nope": int(cfg["qk_nope_head_dim"]), "qk_rope": int(cfg["qk_rope_head_dim"]),
        "v_head": int(cfg["v_head_dim"]),
        "vocab": pad256(int(cfg["vocab_size"])), "vocab_size": int(cfg["vocab_size"]),
        "n_experts": int(cfg["published"]["n_routed_experts"]),
        "experts_held": int(cfg["n_routed_experts"]),
        "top_k": int(cfg["num_experts_per_tok"]),
        "d_ff": int(cfg["intermediate_size"]), "d_ff_expert": int(cfg["moe_intermediate_size"]),
        "n_shared": int(cfg["n_shared_experts"]),
        "scoring": cfg["scoring_func"],
        "n_group": int(cfg["n_group"]), "topk_group": int(cfg["topk_group"]),
        "routed_scaling": float(cfg["routed_scaling_factor"]),
        "aux_coef": float(cfg["training"]["aux_loss_alpha"]),
        "bias_rate": float(cfg["training"]["bias_update_speed"]),
        "rope_theta": float(cfg["rope_theta"]),
        "yarn": dict(zip(_YARN, map(float, yarn))),
        "eps": float(cfg["rms_norm_eps"]),
        "layers": [{"mixer": "attn", "ffn": "dense" if i < dense else "moe"}
                   for i in range(int(cfg["num_hidden_layers"]))],
    }


def spec_from_port(pcfg) -> dict:
    """The same dict from one of the program's ``ModelConfig`` objects."""
    m, moe, y = pcfg.mla, pcfg.moe, pcfg.yarn
    return {
        "d_model": pcfg.d_model, "n_heads": pcfg.num_heads,
        "q_lora_rank": m.q_lora_rank, "kv_lora_rank": m.kv_lora_rank,
        "qk_nope": m.qk_nope_head_dim, "qk_rope": m.qk_rope_head_dim,
        "v_head": m.v_head_dim,
        "vocab": pcfg.padded_vocab, "vocab_size": pcfg.vocab_size,
        "n_experts": moe.num_experts, "experts_held": moe.held, "top_k": moe.top_k,
        "d_ff": pcfg.d_ff, "d_ff_expert": moe.d_ff_expert,
        "n_shared": moe.num_shared_experts,
        "scoring": moe.scoring, "n_group": moe.n_group, "topk_group": moe.topk_group,
        "routed_scaling": moe.routed_scaling_factor,
        "aux_coef": moe.router_aux_coef,
        "bias_rate": moe.bias_update_rate if moe.loss_free_bias else 0.0,
        "rope_theta": pcfg.rope_theta,
        "yarn": {k: float(getattr(y, k)) for k in _YARN} if y is not None else None,
        "eps": 1e-6,                       # models/layers.py::apply_norm
        "layers": [{"mixer": s.mixer, "ffn": s.ffn} for s in pcfg.layer_specs()],
    }


def plan(spec: dict) -> list:
    """[(path, shape, kind, scale)] of every leaf, in the program's tree
    order (``perfbench/weights.py`` makes them)."""
    d, V, H = spec["d_model"], spec["vocab"], spec["n_heads"]
    qr, kvr, nope, rope, dv = (spec["q_lora_rank"], spec["kv_lora_rank"], spec["qk_nope"],
                               spec["qk_rope"], spec["v_head"])
    out = [("embed", (V, d), "normal", 0.02), ("final_norm/scale", (d,), "ones32", 0),
           ("head", (d, V), "normal", d ** -0.5)]
    E, h, f, fd = spec["n_experts"], spec["experts_held"], spec["d_ff_expert"], spec["d_ff"]
    fs = spec["n_shared"] * f
    for i, lay in enumerate(spec["layers"]):
        p = f"layers/{i}/"
        out += [(p + "norm1/scale", (d,), "ones32", 0),
                (p + "mixer/wq_a", (d, qr), "normal", d ** -0.5),
                (p + "mixer/q_a_norm/scale", (qr,), "ones32", 0),
                (p + "mixer/wq_b", (qr, H * (nope + rope)), "normal", qr ** -0.5),
                (p + "mixer/wkv_a", (d, kvr + rope), "normal", d ** -0.5),
                (p + "mixer/kv_a_norm/scale", (kvr,), "ones32", 0),
                (p + "mixer/wkv_b", (kvr, H * (nope + dv)), "normal", kvr ** -0.5),
                (p + "mixer/wo", (H * dv, d), "normal", (H * dv) ** -0.5),
                (p + "norm2/scale", (d,), "ones32", 0)]
        if lay["ffn"] == "dense":
            out += [(p + "ffn/w1", (d, fd), "normal", d ** -0.5),
                    (p + "ffn/w3", (d, fd), "normal", d ** -0.5),
                    (p + "ffn/w2", (fd, d), "normal", fd ** -0.5)]
            continue
        out += [(p + "ffn/router/w", (d, E), "normal32", d ** -0.5),
                (p + "ffn/router/bias", (E,), "zeros32", 0),
                (p + "ffn/w1", (h, d, f), "normal", d ** -0.5),
                (p + "ffn/w3", (h, d, f), "normal", d ** -0.5),
                (p + "ffn/w2", (h, f, d), "normal", f ** -0.5),
                (p + "ffn/shared/w1", (d, fs), "normal", d ** -0.5),
                (p + "ffn/shared/w3", (d, fs), "normal", d ** -0.5),
                (p + "ffn/shared/w2", (fs, d), "normal", f ** -0.5)]
    return out


def _mla_params(spec: dict) -> int:
    d, H = spec["d_model"], spec["n_heads"]
    qr, kvr, nope, rope, dv = (spec["q_lora_rank"], spec["kv_lora_rank"], spec["qk_nope"],
                               spec["qk_rope"], spec["v_head"])
    return (d * qr + qr * H * (nope + rope) + d * (kvr + rope)
            + kvr * H * (nope + dv) + H * dv * d)


def active_matmul_params(spec: dict) -> float:
    """Weights of the products one token goes through: each layer's MLA
    projections, the dense FFN or the router, the shared expert and the
    routed experts this chip holds at top_k x held / E a token, and the LM
    head (the embedding is a lookup)."""
    d, f = spec["d_model"], spec["d_ff_expert"]
    routed = spec["top_k"] * spec["experts_held"] / spec["n_experts"]
    n = d * spec["vocab"]
    for lay in spec["layers"]:
        n += _mla_params(spec)
        if lay["ffn"] == "dense":
            n += 3 * d * spec["d_ff"]
        else:
            n += d * spec["n_experts"] + 3 * d * spec["n_shared"] * f + routed * 3 * d * f
    return n


def attention_flops_fwd(spec: dict, visible_keys: float) -> float:
    """Forward FLOPs of the attention products over ``visible_keys``
    (summed over query positions): the scores at the query/key heads'
    width (qk_nope + qk_rope) and the values at ``v_head``, every head,
    summed over the layers."""
    width = spec["qk_nope"] + spec["qk_rope"] + spec["v_head"]
    return 2.0 * spec["n_heads"] * width * visible_keys * len(spec["layers"])


def train_flops_per_token(spec: dict, seq: int) -> float:
    """Model FLOPs of one trained token: 6 x the active matmul parameters
    plus 3 x the causal attention products' forward, averaged over a
    ``seq``-token sequence (recompute not counted)."""
    attn = attention_flops_fwd(spec, causal_visible(seq)) / seq
    return 6.0 * active_matmul_params(spec) + 3.0 * attn


def expert_leg_least_s(spec: dict, slots: float) -> float:
    """Least time of one MoE layer's routed experts this chip holds,
    forward and backward, over ``slots`` token-slots routed to them: the
    three products forward and six backward at the bf16 rate, or the held
    experts' weights read once and their gradients written once, with the
    slots' rows in and out, at the memory rate.  The shared expert is a
    plain product outside the leg."""
    d, f, h = spec["d_model"], spec["d_ff_expert"], spec["experts_held"]
    flops = 18.0 * slots * d * f
    nbytes = 2 * (2 * 3 * h * d * f + 4 * slots * d)
    return least_s(flops, nbytes)
