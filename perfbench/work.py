"""Operations and bytes the work needs, from a configuration's shapes.

The yardstick for the utilisation and roofline metrics: what the model
requires, not what a kernel happens to do.  Each input byte is read once
and each output byte written once; recomputation is not counted; products
are 2 FLOPs per multiply-add.  ``spec`` is ``perfbench/spec.py``'s dict.

Peaks are the published H100 SXM figures (NVIDIA's data sheet, dense, no
sparsity): 989 TFLOP/s in bf16 and 3.35 TB/s of HBM3.  A card run below
its 700 W limit does not reach them; the harness prints the limit beside
the numbers.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time at the peaks: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


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


def causal_visible(seq: int, window: int = 0) -> float:
    """Sum over the positions of a causal sequence of the keys each sees."""
    if not window or window >= seq:
        return seq * (seq + 1) / 2
    return window * (window + 1) / 2 + (seq - window) * window


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

