"""Mixtral's architecture as the benchmark reads it (arXiv:2401.04088): a
stack of GQA attention + MoE layers, each MoE layer a top-k softmax router
over SwiGLU experts, RMSNorm, an untied LM head.

An architecture file gives the harness what is particular to one model's
layout, and the harness loads it by the name in the configuration file's
``"arch"`` key (``arch/<arch>.py``):

* ``spec_from_file(cfg)`` and ``spec_from_port(pcfg)``: the shape dict
  (``perfbench/spec.py``) of the configuration file and of the program's
  ``ModelConfig``, held against each other before anything is built;
* ``plan(spec)``: every leaf of the weights, in the program's tree order;
* ``train_flops_per_token(spec, seq)``: the model FLOPs of one trained
  token (``train_mfu_pct``);
* ``expert_leg_least_s(spec, slots)``: the least time of one MoE layer's
  expert FFN over ``slots`` routed token-slots of the experts this chip
  holds (``expert_leg_roofline_pct``).

Mixtral's own keys of the shape dict: ``d_model``, ``n_heads``,
``n_kv_heads``, ``head_dim``, ``vocab`` (the embedding's rows, padded to a
multiple of 256), ``d_ff_expert``, ``aux_coef``, ``rope_theta``, ``eps``
and ``window`` (0 = full causal).  Every layer is {"mixer": "attn", "ffn":
"moe"}, and this chip holds every expert (one EP peer).
"""

from __future__ import annotations

from perfbench.spec import pad256
from perfbench.work import causal_visible, least_s


def spec_from_file(cfg: dict) -> dict:
    """The shapes a configuration file states, as run."""
    n_heads = int(cfg["num_attention_heads"])
    d = int(cfg["hidden_size"])
    return {
        "d_model": d, "n_heads": n_heads,
        "n_kv_heads": int(cfg["num_key_value_heads"]),
        "head_dim": int(cfg.get("head_dim") or d // n_heads),
        "vocab": pad256(int(cfg["vocab_size"])), "vocab_size": int(cfg["vocab_size"]),
        "n_experts": int(cfg["num_local_experts"]), "top_k": int(cfg["num_experts_per_tok"]),
        "experts_held": int(cfg["num_local_experts"]),
        "d_ff_expert": int(cfg["intermediate_size"]),
        "aux_coef": float(cfg["router_aux_loss_coef"]),
        "rope_theta": float(cfg["rope_theta"]),
        "eps": float(cfg["rms_norm_eps"]),
        "window": int(cfg.get("sliding_window") or 0),
        "layers": [{"mixer": "attn", "ffn": "moe"}] * int(cfg["num_hidden_layers"]),
    }


def spec_from_port(pcfg) -> dict:
    """The same dict from one of the program's ``ModelConfig`` objects."""
    specs = pcfg.layer_specs()
    attn = next((s.attn for s in specs if s.mixer == "attn"), None)
    moe = pcfg.moe
    return {
        "d_model": pcfg.d_model, "n_heads": pcfg.num_heads,
        "n_kv_heads": pcfg.num_kv_heads, "head_dim": pcfg.resolved_head_dim,
        "vocab": pcfg.padded_vocab, "vocab_size": pcfg.vocab_size,
        "n_experts": moe.num_experts if moe else 0, "top_k": moe.top_k if moe else 0,
        "experts_held": moe.num_experts if moe else 0,
        "d_ff_expert": moe.d_ff_expert if moe else 0,
        "aux_coef": moe.router_aux_coef if moe else 0.0,
        "rope_theta": pcfg.rope_theta if attn is not None and attn.rope else 0.0,
        "eps": 1e-6,                       # models/layers.py::apply_norm
        "window": attn.window if attn is not None and attn.kind == "window" else 0,
        "layers": [{"mixer": s.mixer, "ffn": s.ffn} for s in specs],
    }


def plan(spec: dict) -> list:
    """[(path, shape, kind, scale)] of every leaf, in the program's tree
    order (``perfbench/weights.py`` makes them)."""
    d, V = spec["d_model"], spec["vocab"]
    H, KH, hd = spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
    out = [("embed", (V, d), "normal", 0.02), ("final_norm/scale", (d,), "ones32", 0),
           ("head", (d, V), "normal", d ** -0.5)]
    E, f = spec["n_experts"], spec["d_ff_expert"]
    for i, _ in enumerate(spec["layers"]):
        p = f"layers/{i}/"
        out += [(p + "norm1/scale", (d,), "ones32", 0),
                (p + "mixer/wq", (d, H * hd), "normal", d ** -0.5),
                (p + "mixer/wk", (d, KH * hd), "normal", d ** -0.5),
                (p + "mixer/wv", (d, KH * hd), "normal", d ** -0.5),
                (p + "mixer/wo", (H * hd, d), "normal", (H * hd) ** -0.5),
                (p + "norm2/scale", (d,), "ones32", 0),
                (p + "ffn/router/w", (d, E), "normal32", d ** -0.5),
                (p + "ffn/router/bias", (E,), "zeros32", 0),
                (p + "ffn/w1", (E, d, f), "normal", d ** -0.5),
                (p + "ffn/w3", (E, d, f), "normal", d ** -0.5),
                (p + "ffn/w2", (E, f, d), "normal", f ** -0.5)]
    return out


def active_matmul_params(spec: dict) -> int:
    """Weights of the products one token goes through: each layer's
    attention projections, router and top-k experts, and the LM head (the
    embedding is a lookup)."""
    d, H, KH, hd = spec["d_model"], spec["n_heads"], spec["n_kv_heads"], spec["head_dim"]
    layer = (d * H * hd * 2 + d * KH * hd * 2 + d * spec["n_experts"]
             + spec["top_k"] * 3 * d * spec["d_ff_expert"])
    return len(spec["layers"]) * layer + d * spec["vocab"]


def attention_flops_fwd(spec: dict, visible_keys: float) -> float:
    """Forward FLOPs of the attention products (scores and values) over
    ``visible_keys``, the sum over query positions of the keys each one
    sees, summed over the attention layers."""
    return 4.0 * spec["n_heads"] * spec["head_dim"] * visible_keys * len(spec["layers"])


def train_flops_per_token(spec: dict, seq: int) -> float:
    """Model FLOPs of one trained token: 6 x the active matmul parameters
    plus 3 x the causal attention products' forward, averaged over a
    ``seq``-token sequence (recompute not counted)."""
    attn = attention_flops_fwd(spec, causal_visible(seq, spec["window"])) / seq
    return 6.0 * active_matmul_params(spec) + 3.0 * attn


def expert_leg_least_s(spec: dict, slots: float) -> float:
    """Least time of one MoE layer's expert FFN, forward and backward, over
    ``slots`` routed token-slots: the forward's three products and the
    backward's six (input and weight gradients), each at the bf16 rate; or
    the experts' weights read once and their gradients written once, with
    the slots' rows in and out, at the memory rate."""
    d, f, E = spec["d_model"], spec["d_ff_expert"], spec["n_experts"]
    flops = 18.0 * slots * d * f
    nbytes = 2 * (2 * 3 * E * d * f + 4 * slots * d)
    return least_s(flops, nbytes)
