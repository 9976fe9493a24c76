"""Architecture registry: ``--arch <id>`` → ModelConfig."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, smoke_variant
from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma_2b
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as _llama4_maverick
from repro_torch.configs.granite_8b import CONFIG as _granite_8b
from repro_torch.configs.mistral_nemo_12b import CONFIG as _mistral_nemo_12b
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2_1_8b
from repro_torch.configs.command_r_35b import CONFIG as _command_r_35b
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_3_2_vision_11b
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2_130m
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless_m4t_medium
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3_671b

# The ten assigned architectures (public-pool assignment), in spec order.
ASSIGNED_ARCHS: List[str] = [
    "recurrentgemma-2b",
    "llama4-maverick-400b-a17b",
    "granite-8b",
    "mistral-nemo-12b",
    "internlm2-1.8b",
    "command-r-35b",
    "llama-3.2-vision-11b",
    "mamba2-130m",
    "deepseek-moe-16b",
    "seamless-m4t-medium",
]

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _recurrentgemma_2b,
        _llama4_maverick,
        _granite_8b,
        _mistral_nemo_12b,
        _internlm2_1_8b,
        _command_r_35b,
        _llama_3_2_vision_11b,
        _mamba2_130m,
        _deepseek_moe_16b,
        _seamless_m4t_medium,
        _deepseek_v3_671b,   # the paper's own model, extra to the assignment
    ]
}

ALL_ARCHS: List[str] = list(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return smoke_variant(get_config(name[: -len("-smoke")]))
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs(include_paper: bool = True) -> List[str]:
    return ALL_ARCHS if include_paper else list(ASSIGNED_ARCHS)
