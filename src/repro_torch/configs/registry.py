"""Registry of the DLRM configurations the port serves."""
from __future__ import annotations

from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.dlrm_rm2 import DLRM_CONFIGS


def get_dlrm(name: str) -> DLRMConfig:
    if name not in DLRM_CONFIGS:
        raise KeyError(f"unknown dlrm config {name!r}; "
                       f"available: {sorted(DLRM_CONFIGS)}")
    return DLRM_CONFIGS[name]
