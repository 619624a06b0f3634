"""Wrappers of the hand-written Hopper embedding-bag kernels.

``csrc/embedding_bag.cu`` pools one warp per (sample, table) bag. Its three
entry points replace three TPU kernels:

  embedding_bag         <- ``embedding_bag_pallas``
                           (``src/repro/kernels/embedding_bag.py:45``)
  cached_embedding_bag  <- ``cached_embedding_bag_pallas``
                           (``src/repro/kernels/cached_embedding_bag.py:47``)
  embedding_bag_blocked <- ``embedding_bag_pallas_blocked``
                           (``src/repro/kernels/embedding_bag.py:107``)

The source file says what bounds them and how the design answers that.
The wrappers take CUDA tensors only; ``kernels.ops`` routes CPU tensors
to the plain versions in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("embedding_bag")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.embedding_bag_launch.argtypes = [p, i, ll, p, p, i, i, i, i, p]
    lib.embedding_bag_launch.restype = i
    lib.cached_embedding_bag_launch.argtypes = [
        p, p, i, ll, ll, i, p, p, p, i, i, i, i, p]
    lib.cached_embedding_bag_launch.restype = i
    lib.embedding_bag_blocked_launch.argtypes = [p, i, ll, p, p, p, i, i, i,
                                                 i, i, p]
    lib.embedding_bag_blocked_launch.restype = i
    lib.embedding_bag_error_string.argtypes = [i]
    lib.embedding_bag_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().embedding_bag_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed (cudaError {err}: {msg})")


def _shapes(op: str, tables: torch.Tensor, indices: torch.Tensor):
    if tables.dim() != 3 or indices.dim() != 3:
        raise ValueError(f"{op}: want tables (T, R, d) and indices (B, T, L), "
                         f"got {tuple(tables.shape)} and "
                         f"{tuple(indices.shape)}")
    T, R, d = tables.shape
    B, T2, L = indices.shape
    if T2 != T or min(B, T, R, L, d) < 1:
        raise ValueError(f"{op}: shapes disagree or are empty: tables "
                         f"{tuple(tables.shape)}, indices "
                         f"{tuple(indices.shape)}")
    return B, T, R, L, d


def embedding_bag(tables: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """tables (T, R, d) fp32|bf16, indices (B, T, L) int32, contiguous on
    one CUDA device -> pooled (B, T, d) fp32.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    op = "embedding_bag"
    _build.check_inputs(op, tables={"tables": tables},
                        ids={"indices": indices})
    B, T, R, L, d = _shapes(op, tables, indices)
    out = torch.empty((B, T, d), device=tables.device, dtype=torch.float32)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = _lib().embedding_bag_launch(
            tables.data_ptr(), int(tables.dtype == torch.bfloat16), R,
            indices.data_ptr(), out.data_ptr(), B, T, L, d, stream)
    _raise_on(err, f"{op} at B={B} T={T} R={R} L={L} d={d} {tables.dtype}")
    return out


def cached_shapes(op: str, fast: torch.Tensor, bulk: torch.Tensor,
                  fast_idx: torch.Tensor, bulk_idx: torch.Tensor):
    """(B, T, S+1, R+1, L, d) of a two-tier bag whose bulk tier is either
    (T, R+1, d) or one (R+1, d) tier shared by every table; ValueError
    where the shapes disagree."""
    B, T, S1, L, d = _shapes(op, fast, fast_idx)
    if bulk.dim() not in (2, 3):
        raise ValueError(f"{op}: want bulk (T, R+1, d) or (R+1, d), got "
                         f"{tuple(bulk.shape)}")
    Tb, R1, db = (T, *bulk.shape) if bulk.dim() == 2 else bulk.shape
    if Tb != T or db != d or R1 < 1 or fast_idx.shape != bulk_idx.shape:
        raise ValueError(f"{op}: tiers disagree: fast {tuple(fast.shape)}, "
                         f"bulk {tuple(bulk.shape)}, fast_idx "
                         f"{tuple(fast_idx.shape)}, bulk_idx "
                         f"{tuple(bulk_idx.shape)}")
    return B, T, S1, R1, L, d


def cached_embedding_bag(fast: torch.Tensor, bulk: torch.Tensor,
                         fast_idx: torch.Tensor,
                         bulk_idx: torch.Tensor) -> torch.Tensor:
    """fast (T, S+1, d) and bulk (T, R+1, d) of one dtype (fp32|bf16),
    fast_idx and bulk_idx (B, T, L) int32 pre-translated slots, contiguous
    on one CUDA device -> pooled (B, T, d) fp32, the two tiers' pools
    added. A 2-D bulk (R+1, d) is one tier that every table reads (the
    host tier's chunk cache, ``bulk_idx`` its positions).

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    op = "cached_embedding_bag"
    _build.check_inputs(op, tables={"fast": fast, "bulk": bulk},
                        ids={"fast_idx": fast_idx, "bulk_idx": bulk_idx})
    B, T, S1, R1, L, d = cached_shapes(op, fast, bulk, fast_idx, bulk_idx)
    out = torch.empty((B, T, d), device=fast.device, dtype=torch.float32)
    with torch.cuda.device(fast.device):
        stream = torch.cuda.current_stream(fast.device).cuda_stream
        err = _lib().cached_embedding_bag_launch(
            fast.data_ptr(), bulk.data_ptr(),
            int(fast.dtype == torch.bfloat16), S1, R1, int(bulk.dim() == 2),
            fast_idx.data_ptr(), bulk_idx.data_ptr(), out.data_ptr(), B, T,
            L, d, stream)
    _raise_on(err, f"{op} at B={B} T={T} S+1={S1} R+1={R1} L={L} d={d} "
                   f"{'shared ' * (bulk.dim() == 2)}{fast.dtype}")
    return out


def check_lblk(op: str, n_lookups: int, lblk: int) -> None:
    """The blocked bag reads whole L-blocks: lblk >= 1 must divide L."""
    if lblk < 1 or n_lookups % lblk:
        raise ValueError(f"{op}: lblk={lblk} must be >= 1 and divide the "
                         f"lookups a bag (L={n_lookups})")


def embedding_bag_blocked_flag(tables: torch.Tensor, indices: torch.Tensor,
                               *, lblk: int = 8):
    """``embedding_bag_blocked``, plus the one-element int32 flag the card
    computed: 0 when the stream was aligned and pooled block by block, 1
    when the whole batch took the per-row branch. Nothing here waits for
    the device."""
    op = "embedding_bag_blocked"
    _build.check_inputs(op, tables={"tables": tables},
                        ids={"indices": indices})
    B, T, R, L, d = _shapes(op, tables, indices)
    check_lblk(op, L, lblk)
    out = torch.empty((B, T, d), device=tables.device, dtype=torch.float32)
    flag = torch.empty((1,), device=tables.device, dtype=torch.int32)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        err = _lib().embedding_bag_blocked_launch(
            tables.data_ptr(), int(tables.dtype == torch.bfloat16), R,
            indices.data_ptr(), flag.data_ptr(), out.data_ptr(), B, T, L, d,
            lblk, stream)
    _raise_on(err, f"{op} at B={B} T={T} R={R} L={L} d={d} lblk={lblk} "
                   f"{tables.dtype}")
    return out, flag


def embedding_bag_blocked(tables: torch.Tensor, indices: torch.Tensor, *,
                          lblk: int = 8) -> torch.Tensor:
    """tables (T, R, d) fp32|bf16, indices (B, T, L) int32 with L % lblk
    == 0, contiguous on one CUDA device -> pooled (B, T, d) fp32.

    When every L-block of ``lblk`` lookups is exactly the rows [k*lblk,
    (k+1)*lblk) of its table (and inside it), the kernel reads whole
    blocks; otherwise the whole batch pools row by row, as
    ``embedding_bag``. The card decides which: no host sync. Launches on
    the current stream and does not synchronise. Raises if the kernel does
    not build or its launch is refused."""
    return embedding_bag_blocked_flag(tables, indices, lblk=lblk)[0]
