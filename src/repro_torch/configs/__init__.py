"""Configs of the port (copies of the reference's framework-free ones) and
the architecture registry of the dense, ssm and hybrid families:
``get_config("qwen1.5-0.5b")`` returns the full config,
``get_config(..., reduced=True)`` the smoke-test variant."""
from repro_torch.configs.base import (NETWORK_PROFILES, DPConfig,
                                      ModelConfig, NetworkConfig,
                                      RuntimeConfig, ServingConfig,
                                      SSMConfig, VFLConfig)
from repro_torch.configs.dense import (DEEPSEEK_7B, MINICPM_2B, QWEN15_05B,
                                       YI_34B)
from repro_torch.configs.paper_models import PaperFCNConfig, PaperLRConfig
from repro_torch.configs.recurrent import HYMBA_15B, RWKV6_16B

_REGISTRY = {c.name: c for c in (QWEN15_05B, DEEPSEEK_7B, YI_34B, MINICPM_2B,
                                 RWKV6_16B, HYMBA_15B)}
# the reference's moe, vlm and audio architectures; not ported yet
_NOT_PORTED = ("chameleon-34b", "phi3.5-moe-42b-a6.6b", "qwen3-moe-30b-a3b",
               "whisper-small")
ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name!r}: the port builds the dense, ssm and hybrid families "
            "only (the moe, vlm and audio families are ROADMAP Queue 1 "
            "item 11)")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


__all__ = ["ARCH_IDS", "get_config", "ModelConfig", "DPConfig", "VFLConfig",
           "NetworkConfig", "NETWORK_PROFILES", "PaperFCNConfig",
           "PaperLRConfig", "RuntimeConfig", "ServingConfig", "SSMConfig"]
