"""deepseek-v3 [moe] -- multi-head latent attention, 256 routed experts top-8
under a grouped sigmoid router, one shared expert. [arXiv:2412.19437;
https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json]

61L, d_model=7168, 128 heads, dense d_ff=18432 (the first 3 layers),
expert d_ff=2048, vocab=129280.  MLA: q latent 1536, kv latent 512, a
64-wide RoPE key part shared by the heads beside each head's 128-wide part,
value heads of 128.  RoPE theta 10000 under YaRN (factor 40 over 4096
positions, beta_fast 32, beta_slow 1, mscale 1/1).  The router: sigmoid
scores plus a loss-free correction bias (rate 0.001) that only chooses; 8
groups of 32 experts ranked by the sum of their top 2 scores, the top 4
kept; top 8 experts; the chosen scores normalised and scaled by 2.5.  The
auxiliary loss is the sequence-wise balance loss at alpha 0.0001 (the
paper's Section 4.2).  The multi-token prediction module is not built.

``deepseek-v3-ep32`` is one chip of a 32-way expert-parallel group: it
holds 8 of each MoE layer's 256 experts and an eighth of the vocabulary
(16160 rows), and its 5 layers (1 dense, 4 MoE) are one pipeline stage's;
the other layers lie on further stages.
"""

from dataclasses import replace

from repro_torch.configs.base import (AttentionSpec, LayerSpec, MLASpec,
                                      ModelConfig, MoEConfig, YaRNSpec)

_DENSE = LayerSpec(mixer="attn", ffn="dense", attn=AttentionSpec(kind="full"))
_MOE = LayerSpec(mixer="attn", ffn="moe", attn=AttentionSpec(kind="full"))

CONFIG = ModelConfig(
    name="deepseek-v3",
    family="moe",
    source="arXiv:2412.19437 (DeepSeek-V3); huggingface.co/deepseek-ai/DeepSeek-V3",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    head_dim=128,
    pattern=(_MOE,),
    prefix=(_DENSE,) * 3,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared_experts=1,
                  router_aux_coef=0.0001, loss_free_bias=True,
                  bias_update_rate=0.001, strategy="auto", scoring="sigmoid",
                  n_group=8, topk_group=4, routed_scaling_factor=2.5),
    rope_theta=10000.0,
    mla=MLASpec(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128),
    yarn=YaRNSpec(factor=40.0, original_max_position=4096, beta_fast=32.0,
                  beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0),
)

EP32 = replace(CONFIG, name="deepseek-v3-ep32", num_layers=5, prefix=(_DENSE,),
               vocab_size=16160, moe=replace(CONFIG.moe, experts_held=8))

CONFIGS = (EP32,)
