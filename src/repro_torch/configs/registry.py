"""Registry of the LM architectures, the DLRM configs and the LM shape
cells, as the reference's ``repro.configs.registry``."""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from repro_torch.configs.base import (
    DLRMConfig, LM_SHAPES, ModelConfig, ShapeConfig, shape_applicable)
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.deepseek_7b import CONFIG as _deepseek
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.internvl2_26b import CONFIG as _internvl2
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.dlrm_rm2 import DLRM_CONFIGS

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _command_r, _danube, _internlm2, _deepseek, _mixtral,
        _llama4, _jamba, _internvl2, _whisper, _rwkv6,
    )
}

SHAPES: Dict[str, ShapeConfig] = {s.name: s for s in LM_SHAPES}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_dlrm(name: str) -> DLRMConfig:
    if name not in DLRM_CONFIGS:
        raise KeyError(f"unknown dlrm config {name!r}; "
                       f"available: {sorted(DLRM_CONFIGS)}")
    return DLRM_CONFIGS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def iter_cells(include_skipped: bool = False
               ) -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """Yield every (arch, shape) cell with its applicability verdict."""
    for arch in ARCHS.values():
        for shape in LM_SHAPES:
            ok, why = shape_applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, why


def list_cells() -> List[str]:
    return [f"{a.name}/{s.name}" for a, s, ok, _ in iter_cells() if ok]
