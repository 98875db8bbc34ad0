from repro_torch.configs.base import (
    GPU_64G,
    H100_80G,
    AttentionSpec,
    HardwareProfile,
    LayerSpec,
    MLASpec,
    ModelConfig,
    MoEConfig,
    SSMSpec,
    YaRNSpec,
    get_config,
    registry,
)
