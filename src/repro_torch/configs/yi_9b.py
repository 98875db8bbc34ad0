"""yi-9b [dense] — llama-architecture GQA decoder. [arXiv:2403.04652]

48L, d_model=4096, 32 heads (GQA kv=4), d_ff=11008, vocab=64000.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652 (Yi)",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="dense", attn=AttentionSpec(kind="full")),),
    subquadratic=False,  # full attention -> long_500k skipped
)
