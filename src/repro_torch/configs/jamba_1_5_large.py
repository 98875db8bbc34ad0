"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE.

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536,
MoE 16 experts top-2 on every second layer.  [arXiv:2403.19887 / Jamba-1.5]
Period-8 block: attention at index 3, Mamba elsewhere; MoE on odd layers.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig, MoEConfig, SSMSpec

_SSM = SSMSpec(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=128)
_ATT = AttentionSpec(kind="full", rope=False)  # Jamba attention layers use no RoPE

_PERIOD = tuple(
    LayerSpec(
        mixer="attn" if i == 3 else "mamba",
        ffn="moe" if i % 2 == 1 else "dense",
        attn=_ATT,
        ssm=_SSM,
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba); Jamba-1.5-Large model card",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    pattern=_PERIOD,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, strategy="auto"),
    subquadratic=True,   # mamba-dominated; attention is 1/8 of layers
    smoke_pattern=(
        LayerSpec(mixer="mamba", ffn="moe", attn=_ATT, ssm=_SSM),
        LayerSpec(mixer="attn", ffn="dense", attn=_ATT, ssm=_SSM),
    ),
)
