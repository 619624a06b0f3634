"""Wrapper of the hand-written Hopper kernel for the feature interaction.

``csrc/interactions.cu`` replaces the TPU kernel ``interactions_pallas``
(``src/repro/kernels/interactions.py:31``): at most one wave of blocks,
each summing an even share of the batch's samples, a sample's A =
[bot_out; pooled] landing in shared memory by ``cp.async``; the strict
lower triangle of A.A^T is cut into 4 x 4 tiles of pairs that two or
four lanes each sum in fp32 registers, and written after bot_out. The TPU kernel's batch tile
(``block_b``) is not carried over: the kernel picks its own split from
the batch. The source file says what bounds it. The wrapper takes CUDA
tensors only; ``kernels.ops`` routes CPU tensors to
``kernels.ref.interactions_ref``. ``empty_launch`` launches an empty
kernel: the floor a small batch's time is read against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("interactions")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.interactions_launch.argtypes = [p, i, p, i, p, i, i, i, p]
    lib.interactions_launch.restype = i
    lib.interactions_empty_launch.argtypes = [p]
    lib.interactions_empty_launch.restype = i
    lib.interactions_error_string.argtypes = [i]
    lib.interactions_error_string.restype = ctypes.c_char_p
    return lib


def interactions(bot_out: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """bot_out (B, d) and pooled (B, T, d), each fp32 or bf16, contiguous on
    one CUDA device -> (B, d + (T+1)T/2) fp32.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused: A in fp32, its
    rows rounded up to 4 and its d up to 32, must fit 227 KB of shared
    memory (d <= 1,312 at T = 40, d <= 544 at T = 100, bf16 as fp32)."""
    op = "interactions"
    _build.check_inputs(op, tables={"pooled": pooled},
                        other={"bot_out": (bot_out, (torch.float32,
                                                     torch.bfloat16))})
    if pooled.dim() != 3 or bot_out.dim() != 2:
        raise ValueError(f"{op}: want bot_out (B, d) and pooled (B, T, d), "
                         f"got {tuple(bot_out.shape)} and "
                         f"{tuple(pooled.shape)}")
    B, T, d = pooled.shape
    if tuple(bot_out.shape) != (B, d) or min(B, T, d) < 1:
        raise ValueError(f"{op}: shapes disagree or are empty: bot_out "
                         f"{tuple(bot_out.shape)}, pooled "
                         f"{tuple(pooled.shape)}")
    out = torch.empty((B, d + (T + 1) * T // 2), device=pooled.device,
                      dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(pooled.device):
        stream = torch.cuda.current_stream(pooled.device).cuda_stream
        err = lib.interactions_launch(
            bot_out.data_ptr(), int(bot_out.dtype == torch.bfloat16),
            pooled.data_ptr(), int(pooled.dtype == torch.bfloat16),
            out.data_ptr(), B, T, d, stream)
    if err != 0:
        msg = lib.interactions_error_string(err).decode()
        raise RuntimeError(f"{op} launch failed (cudaError {err}: {msg}) at "
                           f"B={B} T={T} d={d} bot_out {bot_out.dtype} "
                           f"pooled {pooled.dtype}")
    return out


def empty_launch(device: torch.device) -> None:
    """Launch one empty block on ``device``'s current stream: the least
    device time a launch takes. A yardstick of measurements, counted
    nowhere."""
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.interactions_empty_launch(
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty launch failed (cudaError {err}: "
                           f"{lib.interactions_error_string(err).decode()})")
