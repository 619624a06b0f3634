"""Hand-written Hopper kernels, with a plain PyTorch version of each.

  fused_bag_interactions -- the serve hot path in one launch: gather ->
                            shared-memory pool accumulator -> A.A^T
                            (csrc/fused_serve.cu, fused_serve.py)

``ops`` dispatches by device: CUDA tensors launch the kernel, CPU tensors
run the plain version in ``ref``.
"""
from repro_torch.kernels.ops import fused_bag_interactions  # noqa: F401
