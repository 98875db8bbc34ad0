"""llama4-scout-17b-a16e [moe] — 16-expert top-1 MoE with a shared expert.

48L, d_model=5120, 40 heads (GQA kv=8), expert d_ff=8192, vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Attention follows the iRoPE layout: 3 chunked-local-attention layers
(chunk 8192, RoPE) then 1 global layer (NoPE) — which makes the arch
sub-quadratic in cache *compute* for local layers and long_500k eligible
with the chunked-local variant (docs/DESIGN.md §4).  Early fusion: multimodal
patches would enter as embeddings; the text backbone is what we build.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig, MoEConfig

_LOCAL = AttentionSpec(kind="chunked", window=8192, rope=True)
_GLOBAL = AttentionSpec(kind="full", rope=False)

_PERIOD = (
    LayerSpec(mixer="attn", ffn="moe", attn=_LOCAL),
    LayerSpec(mixer="attn", ffn="moe", attn=_LOCAL),
    LayerSpec(mixer="attn", ffn="moe", attn=_LOCAL),
    LayerSpec(mixer="attn", ffn="moe", attn=_GLOBAL),
)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    pattern=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  num_shared_experts=1, strategy="auto"),
    rope_theta=500000.0,
    subquadratic=True,
)
