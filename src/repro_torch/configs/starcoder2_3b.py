"""starcoder2-3b [dense] — GQA + RoPE decoder. [arXiv:2402.19173]

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173 (StarCoder2)",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="dense", attn=AttentionSpec(kind="full")),),
    rope_theta=100000.0,
    subquadratic=False,  # full attention -> long_500k skipped (docs/DESIGN.md §4)
)
