"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None``
means CUDA, and the CPU is used only when named explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceArg = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceArg = None) -> torch.device:
    """``None`` -> the current CUDA device; raises if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card "
                "by default; pass device='cpu' (--device cpu) to run its "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
