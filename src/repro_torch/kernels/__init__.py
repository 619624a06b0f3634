"""Hand-written Hopper kernels, with a plain PyTorch version of each.

  fused_bag_interactions         -- the serve hot path in one launch:
                                    gather -> shared-memory pool
                                    accumulator -> A.A^T
                                    (csrc/fused_serve.cu, fused_serve.py)
  fused_cached_bag_interactions  -- the same over the tiered store's two
                                    tiers, both rows of a lookup summed
                                    (same files)
  fused_grouped_bag_interactions -- the same over a tiered plan's fast and
                                    bulk table groups, output un-permuted
                                    in the kernel (same files)
  embedding_bag                  -- gather + sum-pool, one warp a bag
                                    (csrc/embedding_bag.cu, embedding_bags.py)
  cached_embedding_bag           -- the two-tier bag of the tiered store
                                    (same files)
  interactions                   -- A.A^T strict lower triangle after
                                    bot_out, one block a sample
                                    (csrc/interactions.cu,
                                    feature_interactions.py)
  flash_attention                -- blockwise GQA attention, causal and/or
                                    sliding-window masks
                                    (csrc/flash_attention.cu, attention.py)
  flash_decode                   -- one-token GQA attention over the valid
                                    prefix of a KV cache
                                    (csrc/flash_decode.cu, attention.py)

``ops`` dispatches by device: CUDA tensors launch the kernel, CPU tensors
run the plain version in ``ref``. The eight names are those of the JAX
package's ``repro.kernels`` (the wrapper modules are named apart from
the ops, so an op never shadows its module here). A ninth op,
``ops.embedding_bag_blocked`` (the bag read ``lblk`` aligned rows at a
time, csrc/embedding_bag.cu's third entry point), is a function of the
embedding-bag module in the JAX package and stays out of this list too,
as does ``ops.fused_grouped_bag_interactions_unpermuted``, the grouped
op on ids in original table order (the tiered exchange's serve path).
The TPU kernels' tile arguments (``block_b``, ``block_q``, ``block_k``)
are not carried over, since each kernel picks its own tiles.
"""
from repro_torch.kernels.ops import (  # noqa: F401
    cached_embedding_bag, embedding_bag, flash_attention, flash_decode,
    fused_bag_interactions, fused_cached_bag_interactions,
    fused_grouped_bag_interactions, interactions)
