"""Wrapper of the hand-written Hopper kernel for the fused serve hot path.

``fused_bag_interactions`` launches ``csrc/fused_serve.cu``, which
replaces the TPU kernel ``fused_bag_interactions_pallas``
(``src/repro/kernels/fused_serve.py:134``): gather -> sum-pool ->
pairwise interaction in one launch, one block per sample, the pooled
accumulator kept in shared memory. The source file says what bounds it
and how the design answers that.

The wrapper takes CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_serve")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bag_interactions_launch.argtypes = [
        p, i, p, p, p, i, i, ctypes.c_longlong, i, i, p]
    lib.fused_bag_interactions_launch.restype = i
    lib.fused_serve_error_string.argtypes = [i]
    lib.fused_serve_error_string.restype = ctypes.c_char_p
    return lib


def _check(tables: torch.Tensor, indices: torch.Tensor,
           bot_out: torch.Tensor) -> None:
    for name, x in (("tables", tables), ("indices", indices),
                    ("bot_out", bot_out)):
        if x.device.type != "cuda":
            raise ValueError(f"fused_bag_interactions: {name} must be a "
                             f"CUDA tensor, got device {x.device}")
        if x.device != tables.device:
            raise ValueError(f"fused_bag_interactions: {name} is on "
                             f"{x.device}, tables on {tables.device}")
        if not x.is_contiguous():
            raise ValueError(f"fused_bag_interactions: {name} must be "
                             f"contiguous")
    if tables.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_bag_interactions: tables must be float32 "
                         f"or bfloat16, got {tables.dtype}")
    if indices.dtype != torch.int32:
        raise ValueError(f"fused_bag_interactions: indices must be int32, "
                         f"got {indices.dtype}")
    if bot_out.dtype != torch.float32:
        raise ValueError(f"fused_bag_interactions: bot_out must be float32, "
                         f"got {bot_out.dtype}")
    if tables.dim() != 3 or indices.dim() != 3:
        raise ValueError(f"fused_bag_interactions: want tables (T, R, d) and "
                         f"indices (B, T, L), got {tuple(tables.shape)} and "
                         f"{tuple(indices.shape)}")
    T, R, d = tables.shape
    B, T2, L = indices.shape
    if T2 != T or tuple(bot_out.shape) != (B, d) or min(B, T, R, L, d) < 1:
        raise ValueError(
            f"fused_bag_interactions: shapes disagree or are empty: tables "
            f"{tuple(tables.shape)}, indices {tuple(indices.shape)}, "
            f"bot_out {tuple(bot_out.shape)}")


def fused_bag_interactions(tables: torch.Tensor, indices: torch.Tensor,
                           bot_out: torch.Tensor) -> torch.Tensor:
    """tables (T, R, d) fp32|bf16, indices (B, T, L) int32, bot_out (B, d)
    fp32, all contiguous on one CUDA device -> (B, d + (T+1)T/2) fp32.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    _check(tables, indices, bot_out)
    T, R, d = tables.shape
    B, _, L = indices.shape
    out = torch.empty((B, d + (T + 1) * T // 2), device=tables.device,
                      dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = lib.fused_bag_interactions_launch(
            tables.data_ptr(), int(tables.dtype == torch.bfloat16),
            indices.data_ptr(), bot_out.data_ptr(), out.data_ptr(),
            B, T, R, L, d, stream)
    if err != 0:
        msg = lib.fused_serve_error_string(err).decode()
        raise RuntimeError(f"fused_bag_interactions launch failed "
                           f"(cudaError {err}: {msg}) at B={B} T={T} "
                           f"R={R} L={L} d={d} {tables.dtype}")
    return out
