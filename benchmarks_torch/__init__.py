"""The port's benchmarks: the counterparts of ``benchmarks/`` that run
``repro_torch`` on the card (``python -m benchmarks_torch.run``).

They import torch, numpy, the standard library and ``repro_torch``, never
JAX, ``repro`` or ``benchmarks``.
"""
