"""The paper's own experiment models (Table 3): layer-reduced DeepSeek-V3.

Model I : 16L, Model II: 8L — s=4096, h=7168, a=128 heads, g_d=18432 (dense
FFN), g_e=2048 (expert FFN), top-k=8, V=129280, d_l=3 leading dense layers.
DeepSeek-V3 routing shape: 256 routed experts + 1 shared expert, top-8,
auxiliary-loss-free bias balancing.  [paper Table 3; arXiv:2412.19437]

Adaptation note (docs/DESIGN.md §2): the paper trains with MLA; Table 2's memory
model parameterises attention as generic (a, k_a, h_d), so we instantiate
standard MHA with head_dim=128 and k_a=a.  256 % 16 == 0 -> ep_shardmap.
"""

from repro_torch.configs.base import AttentionSpec, LayerSpec, ModelConfig, MoEConfig

_DENSE = LayerSpec(mixer="attn", ffn="dense", attn=AttentionSpec(kind="full"))
_MOE = LayerSpec(mixer="attn", ffn="moe", attn=AttentionSpec(kind="full"))

_MOE_CFG = MoEConfig(
    num_experts=256,
    top_k=8,
    d_ff_expert=2048,
    num_shared_experts=1,
    loss_free_bias=True,
    strategy="auto",
)


def _model(name: str, layers: int) -> ModelConfig:
    # 3 leading dense layers (the prefix), then identical MoE layers
    prefix, pattern = (_DENSE,) * 3, (_MOE,)
    return ModelConfig(
        name=name,
        family="moe",
        source="MemFine paper Table 3 (layer-reduced DeepSeek-V3); arXiv:2412.19437",
        num_layers=layers,
        d_model=7168,
        num_heads=128,
        num_kv_heads=8,   # GQA stand-in for MLA's compressed KV (docs/DESIGN.md §2)
        d_ff=18432,
        vocab_size=129280,
        head_dim=128,
        pattern=pattern,
        prefix=prefix,
        moe=_MOE_CFG,
        subquadratic=False,
        smoke_pattern=(_DENSE, _MOE),
    )


MODEL_I = _model("deepseek-mini-16l", 16)
MODEL_II = _model("deepseek-mini-8l", 8)

CONFIG = MODEL_I
CONFIGS = (MODEL_II,)
