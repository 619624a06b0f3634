"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Laid out module for module like ``repro``, which stays the reference.
This package imports neither JAX nor anything of ``repro``. Its entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
on the CPU every kernel runs its plain PyTorch version.
"""
