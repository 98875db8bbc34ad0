"""whisper-small [audio] — encoder-decoder transformer backbone. [arXiv:2212.04356]

12 encoder + 12 decoder layers, d_model=768, 12 heads, d_ff=3072, vocab=51865.
The mel-spectrogram + conv frontend is a STUB per the assignment carve-out:
``input_specs`` supplies precomputed frame embeddings (batch, 1500, d_model).
LayerNorm + learned-position style (no RoPE), MHA (kv == heads).
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356 (Whisper)",
    num_layers=12,              # decoder layers
    encoder_layers=12,
    encoder_seq=1500,           # 30 s of audio at 50 Hz after the conv frontend
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    pattern=(LayerSpec(mixer="attn", ffn="dense",
                       attn=AttentionSpec(kind="full", rope=False)),),
    learned_pos=32768,   # sized for the assigned decode_32k shape
    subquadratic=False,  # full-attention decoder -> long_500k skipped
)
