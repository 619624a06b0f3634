"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None``
means CUDA, and the CPU is used only when named explicitly.

Under a launcher of k ranks (``torch.distributed.run``, which sets
``LOCAL_RANK``), ``None`` means ``cuda:(LOCAL_RANK % device_count)``: the
ranks of one host share its cards, so k ranks on a host of one card all
run on ``cuda:0``.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceArg = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceArg = None) -> torch.device:
    """``None`` -> the rank's CUDA device (``rank_device_index``) under a
    launcher, else the current CUDA device; raises if there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the card "
                "by default; pass device='cpu' (--device cpu) to run its "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank_device_index())
    return dev


def rank_device_index() -> int:
    """``LOCAL_RANK % device_count`` when a launcher set ``LOCAL_RANK``,
    else the current CUDA device."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.cuda.current_device()
    return int(local) % torch.cuda.device_count()
