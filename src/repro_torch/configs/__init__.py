from repro_torch.configs.base import DLRMConfig  # noqa: F401
from repro_torch.configs.registry import DLRM_CONFIGS, get_dlrm  # noqa: F401
