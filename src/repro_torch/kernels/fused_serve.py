"""Wrappers of the hand-written Hopper kernel for the fused serve hot path.

``csrc/fused_serve.cu`` computes gather -> sum-pool -> pairwise
interaction in one launch, the pooled accumulator kept in shared memory:
a thread-block cluster a sample, each block's pooled rows pushed to its
peers through distributed shared memory (the two-tier entry point loads
only a lookup's real row and adds the other tier's pad from registers).
Its three entry points replace three TPU kernels:

  fused_bag_interactions          <- ``fused_bag_interactions_pallas``
                                     (``src/repro/kernels/fused_serve.py:134``)
  fused_cached_bag_interactions   <- ``fused_cached_bag_interactions_pallas``
                                     (``src/repro/kernels/fused_serve.py:181``)
  fused_grouped_bag_interactions  <- ``fused_grouped_bag_interactions_pallas``
                                     (``src/repro/kernels/fused_serve.py:244``),
                                     and its form on ids in original table
                                     order, ``..._unpermuted``

The source file says what bounds them and how the design answers that.
The wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_serve")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bag_interactions_launch.argtypes = [
        p, i, p, p, p, i, i, ctypes.c_longlong, i, i, p]
    lib.fused_bag_interactions_launch.restype = i
    lib.fused_grouped_bag_interactions_launch.argtypes = [
        p, p, i, ctypes.c_longlong, i, ctypes.c_longlong, i, p, p, p, p, p,
        i, i, i, p]
    lib.fused_grouped_bag_interactions_launch.restype = i
    lib.fused_cached_bag_interactions_launch.argtypes = [
        p, p, i, ctypes.c_longlong, ctypes.c_longlong, p, p, p, p, i, i, i,
        i, p]
    lib.fused_cached_bag_interactions_launch.restype = i
    lib.fused_serve_error_string.argtypes = [i]
    lib.fused_serve_error_string.restype = ctypes.c_char_p
    return lib


def _check(tables: torch.Tensor, indices: torch.Tensor,
           bot_out: torch.Tensor) -> None:
    _build.check_inputs("fused_bag_interactions", tables={"tables": tables},
                        ids={"indices": indices}, fp32={"bot_out": bot_out})
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


def fused_cached_bag_interactions(fast: torch.Tensor, bulk: torch.Tensor,
                                  fast_idx: torch.Tensor,
                                  bulk_idx: torch.Tensor,
                                  bot_out: torch.Tensor) -> torch.Tensor:
    """fast (T, S+1, d) and bulk (T, R+1, d) of one dtype (fp32|bf16),
    fast_idx and bulk_idx (B, T, L) int32 pre-translated slots, bot_out
    (B, d) fp32, all contiguous on one CUDA device -> (B, d + (T+1)T/2)
    fp32: the two rows of every lookup summed (pad rows as they are, zero
    or not), then the interaction. Each tier has fewer than 2**31 rows.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    op = "fused_cached_bag_interactions"
    _build.check_inputs(op, tables={"fast": fast, "bulk": bulk},
                        ids={"fast_idx": fast_idx, "bulk_idx": bulk_idx},
                        fp32={"bot_out": bot_out})
    if fast.dim() != 3 or bulk.dim() != 3 or fast_idx.dim() != 3:
        raise ValueError(f"{op}: want tiers (T, rows, d) and ids (B, T, L)")
    T, S1, d = fast.shape
    B, _, L = fast_idx.shape
    if (bulk.shape[0] != T or bulk.shape[2] != d
            or fast_idx.shape != bulk_idx.shape or fast_idx.shape[1] != T
            or tuple(bot_out.shape) != (B, d)
            or min(B, T, S1, bulk.shape[1], L, d) < 1):
        raise ValueError(
            f"{op}: shapes disagree or are empty: fast {tuple(fast.shape)}, "
            f"bulk {tuple(bulk.shape)}, fast_idx {tuple(fast_idx.shape)}, "
            f"bulk_idx {tuple(bulk_idx.shape)}, bot_out "
            f"{tuple(bot_out.shape)}")
    R1 = bulk.shape[1]
    out = torch.empty((B, d + (T + 1) * T // 2), device=fast.device,
                      dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(fast.device):
        stream = torch.cuda.current_stream(fast.device).cuda_stream
        err = lib.fused_cached_bag_interactions_launch(
            fast.data_ptr(), bulk.data_ptr(),
            int(fast.dtype == torch.bfloat16), S1, R1, fast_idx.data_ptr(),
            bulk_idx.data_ptr(), bot_out.data_ptr(), out.data_ptr(), B, T,
            L, d, stream)
    if err != 0:
        msg = lib.fused_serve_error_string(err).decode()
        raise RuntimeError(f"{op} launch failed (cudaError {err}: {msg}) at "
                           f"B={B} T={T} S+1={S1} R+1={R1} L={L} d={d} "
                           f"{fast.dtype}")
    return out


def grouped_pos(inv_perm, device: torch.device) -> torch.Tensor:
    """``pos = [0] + [1 + inv_perm]`` as an int32 tensor on ``device``:
    the accumulator slot of each output feature (0 = bot_out), for ids in
    concat(fast, bulk) order."""
    inv = torch.as_tensor(inv_perm, dtype=torch.int32).cpu()
    return torch.cat([torch.zeros(1, dtype=torch.int32), inv + 1]).to(device)


def grouped_src(inv_perm, device: torch.device) -> torch.Tensor:
    """``inv_perm`` as an int32 tensor on ``device``: for ids in original
    table order, the concat(fast, bulk) position each table reads from
    (fast table c if c < Tf, else bulk table c - Tf)."""
    return torch.as_tensor(inv_perm, dtype=torch.int32).to(device)


def _grouped(op: str, tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
             indices: torch.Tensor, bot_out: torch.Tensor,
             src: Optional[torch.Tensor],
             pos: Optional[torch.Tensor]) -> torch.Tensor:
    """Check and launch the grouped entry point with one of ``src`` (ids
    in original order) and ``pos`` (ids in concat order)."""
    table_map = src if src is not None else pos
    _build.check_inputs(
        op, tables={"tables_fast": tables_fast, "tables_bulk": tables_bulk},
        ids={"indices": indices, "src" if src is not None else "pos":
             table_map},
        fp32={"bot_out": bot_out})
    if tables_fast.dim() != 3 or tables_bulk.dim() != 3 \
            or indices.dim() != 3:
        raise ValueError(f"{op}: want tables (T, R, d) and indices (B, T, L)")
    Tf, Rf, d = tables_fast.shape
    Tb, Rb, d2 = tables_bulk.shape
    B, T, L = indices.shape
    map_len = T if src is not None else T + 1
    if (d2 != d or T != Tf + Tb or tuple(bot_out.shape) != (B, d)
            or tuple(table_map.shape) != (map_len,) or min(B, T, L, d) < 1
            or (Tf and Rf < 1) or (Tb and Rb < 1)):
        raise ValueError(
            f"{op}: shapes disagree or are empty: tables_fast "
            f"{tuple(tables_fast.shape)}, tables_bulk "
            f"{tuple(tables_bulk.shape)}, indices {tuple(indices.shape)}, "
            f"bot_out {tuple(bot_out.shape)}, "
            f"{'src' if src is not None else 'pos'} "
            f"{tuple(table_map.shape)}")
    out = torch.empty((B, d + (T + 1) * T // 2), device=bot_out.device,
                      dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(bot_out.device):
        stream = torch.cuda.current_stream(bot_out.device).cuda_stream
        err = lib.fused_grouped_bag_interactions_launch(
            tables_fast.data_ptr(), tables_bulk.data_ptr(),
            int(tables_fast.dtype == torch.bfloat16), Rf, Tf, Rb, Tb,
            None if src is None else src.data_ptr(),
            None if pos is None else pos.data_ptr(), indices.data_ptr(),
            bot_out.data_ptr(), out.data_ptr(), B, L, d, stream)
    if err != 0:
        msg = lib.fused_serve_error_string(err).decode()
        raise RuntimeError(f"{op} launch failed (cudaError {err}: {msg}) at "
                           f"B={B} Tf={Tf} Tb={Tb} Rf={Rf} Rb={Rb} L={L} "
                           f"d={d} {tables_fast.dtype}")
    return out


def fused_grouped_bag_interactions(tables_fast: torch.Tensor,
                                   tables_bulk: torch.Tensor,
                                   indices_perm: torch.Tensor,
                                   bot_out: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """tables_fast (Tf, Rf, d) and tables_bulk (Tb, Rb, d) of one dtype
    (fp32|bf16; either group may be empty), indices_perm (B, Tf+Tb, L)
    int32 in concat(fast, bulk) order, bot_out (B, d) fp32, pos (Tf+Tb+1)
    int32 from ``grouped_pos``; all contiguous on one CUDA device ->
    (B, d + (T+1)T/2) fp32 in the original table order.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    return _grouped("fused_grouped_bag_interactions", tables_fast,
                    tables_bulk, indices_perm, bot_out, None, pos)


def fused_grouped_bag_interactions_unpermuted(
        tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
        indices: torch.Tensor, bot_out: torch.Tensor,
        src: torch.Tensor) -> torch.Tensor:
    """As ``fused_grouped_bag_interactions``, with indices (B, Tf+Tb, L)
    int32 in the ORIGINAL table order and src (Tf+Tb) int32 from
    ``grouped_src``: the kernel walks the tables in their own order, so
    the ids are never permuted."""
    return _grouped("fused_grouped_bag_interactions", tables_fast,
                    tables_bulk, indices, bot_out, src, None)
