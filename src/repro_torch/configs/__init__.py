"""Architecture registry: ``get_config("<arch-id>")`` names the same
models as ``repro.configs``."""
from __future__ import annotations

from repro_torch.configs.base import (MambaConfig, MLAConfig, ModelConfig,
                                      reduced)

from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_06
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.granite_34b import CONFIG as _granite
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3_8b
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.internvl2_76b import CONFIG as _internvl

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in [
        _kimi, _mixtral, _qwen3_06, _minicpm3, _granite,
        _qwen3_8b, _hubert, _rwkv6, _jamba, _internvl,
    ]
}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return REGISTRY[name]


__all__ = ["ARCH_IDS", "MambaConfig", "MLAConfig", "ModelConfig",
           "REGISTRY", "get_config", "reduced"]
