"""mamba2-130m [ssm] — attention-free SSD (state-space duality). [arXiv:2405.21060]

24L, d_model=768, ssm_state=128, vocab=50280, no FFN (d_ff=0): each layer is a
single Mamba-2 mixer.  MemFine's MoE chunking is inapplicable (no MoE) — see
docs/DESIGN.md §Arch-applicability; the memory model + remat scheduling still apply.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMSpec

_SSM = SSMSpec(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=128)

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
    num_layers=24,
    d_model=768,
    num_heads=1,            # unused by the mamba mixer
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerSpec(mixer="mamba", ffn="none", ssm=_SSM),),
    tie_embeddings=True,
    subquadratic=True,      # constant-size state -> long_500k eligible
)
