"""The port's examples: the counterparts of ``examples/`` that run
``repro_torch`` on the card (``--device cpu`` runs them on the host).

They import torch, numpy, the standard library and ``repro_torch``, never
JAX, ``repro`` or ``benchmarks``.
"""
