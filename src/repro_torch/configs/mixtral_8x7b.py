"""mixtral-8x7b [moe] -- 8 experts top-2, sliding-window attention. [arXiv:2401.04088]

32L, d_model=4096, 32 heads (GQA kv=8), expert d_ff=14336, vocab=32000, SWA 4096.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088 (Mixtral of Experts)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="moe",
                       attn=AttentionSpec(kind="window", window=4096)),),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336, strategy="auto"),
    rope_theta=1e6,
    subquadratic=True,
)
