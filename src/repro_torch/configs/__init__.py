from repro_torch.configs.base import (
    GPU_64G,
    H100_80G,
    AttentionSpec,
    HardwareProfile,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    SSMSpec,
    get_config,
    registry,
)
