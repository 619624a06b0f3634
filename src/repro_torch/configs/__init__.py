from repro_torch.configs.base import (  # noqa: F401
    DLRMConfig, LM_SHAPES, ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
    shape_applicable)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, DLRM_CONFIGS, SHAPES, get_arch, get_dlrm, get_shape, iter_cells,
    list_cells)
