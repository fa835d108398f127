"""Configs of the port (copies of the reference's framework-free ones)."""
from repro_torch.configs.base import (NETWORK_PROFILES, DPConfig,
                                      NetworkConfig, VFLConfig)
from repro_torch.configs.paper_models import PaperFCNConfig, PaperLRConfig

__all__ = ["DPConfig", "VFLConfig", "NetworkConfig", "NETWORK_PROFILES",
           "PaperFCNConfig", "PaperLRConfig"]
