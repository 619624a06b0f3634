"""Hand-written Hopper kernels, with a plain PyTorch version of each.

  fused_bag_interactions         -- the serve hot path in one launch:
                                    gather -> shared-memory pool
                                    accumulator -> A.A^T
                                    (csrc/fused_serve.cu, fused_serve.py)
  fused_grouped_bag_interactions -- the same over a tiered plan's fast and
                                    bulk table groups, output un-permuted
                                    in the kernel (same files)
  embedding_bag                  -- gather + sum-pool, one warp a bag
                                    (csrc/embedding_bag.cu, embedding_bags.py)
  cached_embedding_bag           -- the two-tier bag of the tiered store
                                    (same files)

``ops`` dispatches by device: CUDA tensors launch the kernel, CPU tensors
run the plain version in ``ref``.
"""
from repro_torch.kernels.ops import (  # noqa: F401
    cached_embedding_bag, embedding_bag, fused_bag_interactions,
    fused_grouped_bag_interactions)
