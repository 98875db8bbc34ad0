"""internvl2-76b [vlm] — InternViT-6B + Llama-3-70B backbone. [arXiv:2404.16821]

We build the language backbone: 80L, d_model=8192, 64 heads (GQA kv=8),
d_ff=28672, vocab=128256.  The InternViT vision encoder + MLP projector are a
STUB per the assignment carve-out: ``input_specs`` supplies projected patch
embeddings (batch, 256, d_model) that occupy the leading sequence positions.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2); LLM backbone = Llama-3-70B shape",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    pattern=(LayerSpec(mixer="attn", ffn="dense", attn=AttentionSpec(kind="full")),),
    num_patch_tokens=256,
    rope_theta=500000.0,
    subquadratic=False,  # full attention -> long_500k skipped
)
