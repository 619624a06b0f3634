"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``build/kernels/<name>-<hash>.so`` under the checkout
root. The hash covers the source, the shared headers ``csrc/*.cuh`` and
the compiler flags, so an edited source rebuilds and an unchanged one
loads the library already built.
``check_inputs`` is the wrappers' shared check of what they hand a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build with the CUDA toolkit's compiler")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built for
    the current source and flags; returns the library's path."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent builder sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)))


def check_inputs(op: str, *, tables: Dict[str, torch.Tensor],
                 ids: Optional[Dict[str, torch.Tensor]] = None,
                 fp32: Optional[Dict[str, torch.Tensor]] = None,
                 other: Optional[Dict[str, Tuple[torch.Tensor,
                                                 Tuple[torch.dtype, ...]]]]
                 = None) -> None:
    """Raise ValueError unless every tensor lies contiguous on one CUDA
    device, the ``tables`` share one dtype of fp32 or bf16, the ``ids``
    are int32, the ``fp32`` tensors fp32 and each of the ``other`` tensors
    one of the dtypes given beside it."""
    want = [(x, name, (torch.float32, torch.bfloat16))
            for name, x in tables.items()]
    want += [(x, name, (torch.int32,)) for name, x in (ids or {}).items()]
    want += [(x, name, (torch.float32,)) for name, x in (fp32 or {}).items()]
    want += [(x, name, dtypes)
             for name, (x, dtypes) in (other or {}).items()]
    first = next(iter(tables.values()))
    for x, name, dtypes in want:
        if x.device.type != "cuda":
            raise ValueError(f"{op}: {name} must be a CUDA tensor, got "
                             f"device {x.device}")
        if x.device != first.device:
            raise ValueError(f"{op}: {name} is on {x.device}, the "
                             f"tables on {first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if x.dtype not in dtypes:
            raise ValueError(f"{op}: {name} must be "
                             f"{' or '.join(map(str, dtypes))}, got "
                             f"{x.dtype}")
    if len({x.dtype for x in tables.values()}) > 1:
        raise ValueError(f"{op}: the tables' dtypes differ: "
                         f"{[x.dtype for x in tables.values()]}")
