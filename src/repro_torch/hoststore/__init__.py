"""repro_torch.hoststore: the host-side chunked embedding tier.

Completes the memory hierarchy -- HBM hot rows -> device chunk cache ->
host chunk store -- so one card serves and trains models bigger than its
memory, as the reference's ``repro.hoststore``:

  chunks.py   ChunkParamMgr: canonical weights in a host tensor, chunked;
              device chunk cache + indirection table, CLOCK/LFU eviction,
              dirty writeback, batched ``ensure`` faults.
  swap.py     per-micro-batch swap planning priced on the virtual clock;
              ``overlap_stall`` hides micro-batch i+1's faults under
              micro-batch i's MLP (the ``pipeline_depth`` overlap).
  exchange.py HostTieredExchange -- the tier behind the standard
              ``EmbeddingExchange`` interface, bit-identical pooling to the
              all-in-device path; ``build_host_exchange`` sizes the hot
              slab / chunk cache for a device-memory budget.
"""
from .chunks import ChunkParamMgr, EnsureStats, StagingRing, SwapStats
from .exchange import (HostTieredExchange, build_host_exchange,
                       draw_host_tables)
from .swap import SwapPlan, micro_batch_indices, overlap_stall, plan_swaps

__all__ = [
    "ChunkParamMgr", "EnsureStats", "StagingRing", "SwapStats",
    "HostTieredExchange", "build_host_exchange", "draw_host_tables",
    "SwapPlan", "micro_batch_indices", "overlap_stall", "plan_swaps",
]
