"""Public kernel entry points, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel, and a failed build or
launch raises. A CPU tensor runs the plain version in ``kernels.ref``.
Nothing else selects the path: there is no environment switch and no
fallback from the kernel to the plain version.

``launch_counts`` counts, per kernel, the launches made through these
entry points, so a run can show that its main path went through the
kernel. Direct calls of a kernel's wrapper (as when it is held against
its plain version) are not counted.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import fused_serve, ref

launch_counts: Dict[str, int] = {"fused_bag_interactions": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def fused_bag_interactions(tables: torch.Tensor, indices: torch.Tensor,
                           bot_out: torch.Tensor) -> torch.Tensor:
    """(T, R, d) x (B, T, L) x (B, d) -> (B, d + (T+1)T/2) fp32 fused
    gather -> pool -> interaction features; one launch on the card."""
    if tables.device.type == "cuda":
        out = fused_serve.fused_bag_interactions(tables, indices, bot_out)
        launch_counts["fused_bag_interactions"] += 1
        return out
    if tables.device.type == "cpu":
        return ref.fused_bag_interactions_ref(tables, indices, bot_out)
    raise ValueError(f"fused_bag_interactions: no path for tables on "
                     f"{tables.device}")
