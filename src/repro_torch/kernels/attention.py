"""Wrappers of the hand-written Hopper attention kernels.

Two sources, two entry points, replacing two TPU kernels:

  flash_attention  <- ``flash_attention_pallas``
                      (``src/repro/kernels/flash_attention.py:90``):
                      ``csrc/flash_attention.cu``, GQA online-softmax
                      attention with causal and sliding-window masks, one
                      block per (query tile, head, batch), masked key tiles
                      skipped; bf16 (hd a multiple of 8) on the tensor
                      cores: a producer warp's TMA copies feed two
                      warpgroups' wgmma products, 128-row query and key
                      tiles; fp32 on the CUDA cores
  flash_decode     <- ``flash_decode_pallas``
                      (``src/repro/kernels/flash_decode.py:75``):
                      ``csrc/flash_decode.cu``, one query token over the
                      valid prefix of a KV cache, one block per (batch, KV
                      head, group of its query heads, chunk of the valid
                      rows), the chunks merged by a second kernel

The TPU kernels' tile arguments (``block_q``, ``block_k``) are not carried
over: each kernel picks its own tiles. A cache length of 0 gives the
reference's answer (the mean of v over the whole cache), not the TPU
kernel's 0. The source files say what bounds them. The wrappers take CUDA
tensors only; ``kernels.ops`` routes CPU tensors to the plain versions in
``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
LOG2E = math.log2(math.e)


@functools.lru_cache(maxsize=None)
def _attention_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _decode_lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [
        p, p, p, p, i, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    lib.flash_decode_launch.restype = i
    lib.flash_decode_error_string.argtypes = [i]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check_heads(op: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, q_rank: int) -> None:
    """Raise ValueError unless q has ``q_rank`` dims ending (Hq, hd), k and
    v are (B, S, Hkv, hd) alike with Hq a multiple of Hkv, and 1 <= hd <=
    MAX_HEAD_DIM."""
    if q.dim() != q_rank or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{op}: want q of rank {q_rank} and k, v (B, S, "
                         f"Hkv, hd) alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hkv, hd = k.shape
    Hq = q.shape[-2]
    if (q.shape[0] != B or q.shape[-1] != hd or min(B, S, Hkv, hd) < 1
            or Hq % Hkv or q.numel() == 0):
        raise ValueError(f"{op}: shapes disagree or are empty: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dim {hd} > {MAX_HEAD_DIM} is not "
                         f"supported by the kernel")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, T, Hq, hd), k and v (B, S, Hkv, hd), one dtype of fp32 or
    bf16, contiguous on one CUDA device, hd <= 128 -> (B, T, Hq, hd) in
    q's dtype.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    op = "flash_attention"
    _build.check_inputs(op, tables={"q": q, "k": k, "v": v})
    _check_heads(op, q, k, v, 4)
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    # qpos - kpos lies in [1 - S, T - 1]: a window above T masks nothing
    # more than T does, one below -S nothing less than -S does.
    win = 0 if window is None else max(-S, min(int(window), T))
    out = torch.empty_like(q)
    lib = _attention_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, T, S, Hq, Hkv, hd,
            int(causal), int(window is not None), win,
            LOG2E / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{op} launch failed (cudaError {err}: {msg}) at "
                           f"B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
                           f"causal={causal} window={window} {q.dtype}")
    return out


def _decode_chunks(device: torch.device, blocks: int, S: int) -> int:
    """Chunks to split each cache's valid rows into, so that the blocks
    (``blocks`` a chunk: one a batch row, KV head and group of 4 query
    heads) fill ~16 a streaming multiprocessor, none under 256 rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-16 * sms // blocks), S // 256))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, hd), k_cache and v_cache (B, S, Hkv, hd), one dtype of
    fp32 or bf16, lengths (B,) int32 or int64, contiguous on one CUDA
    device, hd <= 128 -> (B, Hq, hd) in q's dtype.

    Launches on the current stream and does not synchronise. Raises if
    the kernel does not build or its launch is refused."""
    op = "flash_decode"
    _build.check_inputs(
        op, tables={"q": q, "k_cache": k_cache, "v_cache": v_cache},
        other={"lengths": (lengths, (torch.int32, torch.int64))})
    _check_heads(op, q, k_cache, v_cache, 3)
    B, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"{op}: lengths {tuple(lengths.shape)}, want "
                         f"({B},)")
    out = torch.empty_like(q)
    chunks = _decode_chunks(q.device, B * Hkv * -(-(Hq // Hkv) // 4), S)
    part = (torch.empty(B * Hq * chunks * (hd + 2), dtype=torch.float32,
                        device=q.device) if chunks > 1 else None)
    lib = _decode_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), int(lengths.dtype == torch.int64),
            out.data_ptr(), None if part is None else part.data_ptr(),
            chunks, int(q.dtype == torch.bfloat16), B, S, Hq, Hkv, hd,
            LOG2E / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"{op} launch failed (cudaError {err}: {msg}) at "
                           f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
                           f"{q.dtype}")
    return out
