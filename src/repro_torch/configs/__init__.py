from repro_torch.configs.base import (ATTN, CROSS_ATTN, INPUT_SHAPES, LOCAL_ATTN,
                                MLA_ATTN, MLP, MOE, NONE, RGLRU, SSM,
                                InputShape, MLAConfig, ModelConfig, MoEConfig,
                                RGLRUConfig, SSMConfig, smoke_variant)
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS, get_config,
                                    list_archs)

__all__ = [
    "ATTN", "CROSS_ATTN", "LOCAL_ATTN", "MLA_ATTN", "RGLRU", "SSM",
    "MLP", "MOE", "NONE",
    "INPUT_SHAPES", "InputShape",
    "ModelConfig", "MoEConfig", "SSMConfig", "RGLRUConfig", "MLAConfig",
    "smoke_variant", "get_config", "list_archs", "ALL_ARCHS", "ASSIGNED_ARCHS",
]
