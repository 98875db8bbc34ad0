"""Config system: model architectures and hardware profiles.

The port's own copy of the JAX package's config dataclasses, with the same
fields and the same derived properties, so a config means the same model in
both packages.  Layer structure is a *period pattern*: a short list of
``LayerSpec`` that repeats down the stack, after an optional unrolled prefix.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class AttentionSpec:
    """Self-attention mixer variant for one layer."""
    kind: str = "full"          # "full" | "window" | "chunked"
    window: int = 0             # window size for "window", chunk size for "chunked"
    rope: bool = True
    qk_norm: bool = False


@dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 (SSD) mixer."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating period: a mixer plus an FFN kind."""
    mixer: str = "attn"         # "attn" | "mamba"
    ffn: str = "dense"          # "dense" | "moe" | "none"
    attn: AttentionSpec = AttentionSpec()
    ssm: SSMSpec = SSMSpec()


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    router_aux_coef: float = 0.01
    loss_free_bias: bool = False
    bias_update_rate: float = 0.001
    strategy: str = "auto"          # "auto" | "ep_shardmap" | "tp_gspmd" | "dense"
    capacity_mode: str = "dropless"
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    source: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix: tuple[LayerSpec, ...] = ()
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_patch_tokens: int = 0
    learned_pos: int = 0
    subquadratic: bool = False
    remat_policy: str = "memfine"
    moe_chunks: int = 1
    smoke_pattern: Optional[tuple[LayerSpec, ...]] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/logits vocab rounded up to a multiple of 256; the real
        ``vocab_size`` stays the label space."""
        return -(-self.vocab_size // 256) * 256

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        """Full per-layer spec list (prefix, then pattern cycled)."""
        p = self.pattern
        body = self.num_layers - len(self.prefix)
        return self.prefix + tuple(p[i % len(p)] for i in range(body))

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prefix)) // len(self.pattern)

    @property
    def remainder_layers(self) -> int:
        """Layers past the last whole period of the pattern."""
        return (self.num_layers - len(self.prefix)) % len(self.pattern)

    def reduced(self, *, d_model: int = 256, max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts, same
        family -- the same reduction as the JAX package's, field for field."""
        if self.smoke_pattern is not None:
            pat = self.smoke_pattern
        else:
            reps: list[LayerSpec] = []
            for ls in self.layer_specs():
                if not any(r.mixer == ls.mixer and r.ffn == ls.ffn for r in reps):
                    reps.append(ls)
                if len(reps) == 2:
                    break
            pat = tuple(reps) if len(reps) == 2 else (reps[0], reps[0])
        heads = 4
        kv = max(1, min(self.num_kv_heads, 2))
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=d_model * 2,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
            )
        ssm_small = SSMSpec(state_dim=16, head_dim=32, expand=2, conv_width=4, chunk=16)
        pat = tuple(replace(ls, ssm=ssm_small,
                            attn=replace(ls.attn, window=min(ls.attn.window, 64) if ls.attn.window else 0))
                    for ls in pat)
        return replace(
            self,
            name=self.name + "-smoke",
            prefix=(),
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=d_model * 3,
            vocab_size=512,
            pattern=pat,
            moe=moe,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            num_patch_tokens=min(self.num_patch_tokens, 8),
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# hardware profiles (for the serving memory model)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareProfile:
    name: str
    hbm_bytes: float
    peak_flops: float               # bf16
    hbm_bw: float                   # bytes/s
    ici_bw: float                   # bytes/s per link
    alpha: float = 0.9              # usable-memory fraction (paper's alpha)


GPU_64G = HardwareProfile("gpu-64g", 64e9, 197e12, 819e9, 50e9)   # paper's 64 GB devices
# NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s, 989 TFLOP/s dense
# bf16, NVLink 450 GB/s each way to each other card of the host
H100_80G = HardwareProfile("h100-80g", 80e9, 989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# registry: every architecture of the JAX package's registry
# ---------------------------------------------------------------------------

# config modules of this package: each defines ``CONFIG`` and may define
# ``CONFIGS``, further variants (deepseek_mini: the paper's Model I and II)
_MODULES = ("mixtral_8x7b", "jamba_1_5_large", "mamba2_130m", "deepseek_mini",
            "llama4_scout", "gemma3_27b", "llama3_2_3b", "yi_9b", "starcoder2_3b",
            "whisper_small", "internvl2_76b")


def registry() -> dict[str, ModelConfig]:
    out: dict[str, ModelConfig] = {}
    for name in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{name}")
        for cfg in (mod.CONFIG, *getattr(mod, "CONFIGS", ())):
            out[cfg.name] = cfg
    return out


def get_config(name: str) -> ModelConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; the port serves {sorted(reg)}")
    return reg[name]
