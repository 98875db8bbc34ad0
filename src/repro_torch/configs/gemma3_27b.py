"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L, d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
[hf:google/gemma-3-27b-pt]  Local layers use a 1024-token sliding window
(-> long_500k eligible via the sliding-window variant); every 6th layer is
global full attention.  QK-norm on, RoPE theta differs local/global (we use
the global theta; local window dominates positions anyway).
62 = 10 full periods of 6 + 2 remainder local layers (handled unrolled).
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig

_LOCAL = AttentionSpec(kind="window", window=1024, rope=True, qk_norm=True)
_GLOBAL = AttentionSpec(kind="full", rope=True, qk_norm=True)

_PERIOD = tuple(
    LayerSpec(mixer="attn", ffn="dense", attn=_LOCAL if i < 5 else _GLOBAL)
    for i in range(6)
)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-27b-pt",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    pattern=_PERIOD,
    rope_theta=1e6,
    tie_embeddings=True,
    subquadratic=True,   # 5/6 of layers are window-1024
    smoke_pattern=(
        LayerSpec(mixer="attn", ffn="dense", attn=_LOCAL),
        LayerSpec(mixer="attn", ffn="dense", attn=_GLOBAL),
    ),
)
