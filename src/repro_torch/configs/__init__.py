"""Configs of the port (copies of the reference's framework-free ones) and
the architecture registry, every family of the reference's (dense, moe,
ssm, hybrid, vlm, audio): ``get_config("qwen1.5-0.5b")`` returns the full
config, ``get_config(..., reduced=True)`` the smoke-test variant."""
from repro_torch.configs.base import (NETWORK_PROFILES, DPConfig,
                                      ModelConfig, MoEConfig, MoEShard,
                                      NetworkConfig, RuntimeConfig,
                                      ServingConfig, SSMConfig, TrainConfig,
                                      VFLConfig)
from repro_torch.configs.dense import (DEEPSEEK_7B, MINICPM_2B, QWEN15_05B,
                                       YI_34B)
from repro_torch.configs.moe import PHI35_MOE_42B, QWEN3_MOE_30B
from repro_torch.configs.multimodal import CHAMELEON_34B, WHISPER_SMALL
from repro_torch.configs.paper_models import PaperFCNConfig, PaperLRConfig
from repro_torch.configs.recurrent import HYMBA_15B, RWKV6_16B

_REGISTRY = {c.name: c for c in (QWEN15_05B, DEEPSEEK_7B, YI_34B, MINICPM_2B,
                                 PHI35_MOE_42B, QWEN3_MOE_30B, CHAMELEON_34B,
                                 WHISPER_SMALL, RWKV6_16B, HYMBA_15B)}
ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


__all__ = ["ARCH_IDS", "get_config", "ModelConfig", "MoEConfig", "MoEShard",
           "DPConfig", "VFLConfig", "NetworkConfig", "NETWORK_PROFILES",
           "PaperFCNConfig", "PaperLRConfig", "RuntimeConfig", "ServingConfig",
           "SSMConfig", "TrainConfig"]
