"""repro_torch.fabric -- cross-board sharded serving, row-range granular.

The port's counterpart of ``repro.fabric``. A `ShardedFleet` is N boards
that TOGETHER hold one partitioned table set (vs `repro_torch.cluster`'s
N full copies). Ownership is a `ShardMap` of row-range shards --
`partition_rows` extends the planner's greedy access-density placement
to board ownership with per-byte capacity accounting, splitting a table
no single board fits into contiguous row ranges (`partition_tables` keeps
whole-table granularity for feasibility probes). `FabricExchange` routes
lookups to row owners and meters the modeled fabric link
(`perf_model.fabric_exchange_time`), and each board's `RemoteRowCache`
(LFU over remote hot rows keyed by global (table, row)) turns most
cross-board lookups into local ones under Zipf traffic. `fabric.elastic`
re-partitions LIVE: `expand_map` / `shrink_map` grow or shrink the fleet
and `plan_migration` schedules the minimal row movement, so an
`SLAAutoscaler`-driven fleet breathes with load mid-trace. Served values
are bit-identical to a single full board in every configuration, before,
during and after every re-partition. Owners pool with row 4, the
hand-written bag kernel (`kernels.ops.embedding_bag`), on the card.
"""
from repro_torch.fabric.cache import RemoteRowCache
from repro_torch.fabric.elastic import (MigrationPlan, RowMove, expand_map,
                                        plan_migration, shrink_map)
from repro_torch.fabric.exchange import ExchangeTraffic, FabricExchange
from repro_torch.fabric.fleet import FabricBoard, FabricReport, ShardedFleet
from repro_torch.fabric.partition import (PartitionMap, Shard, ShardMap,
                                          fits_one_board, partition_rows,
                                          partition_tables)

__all__ = [
    "ShardedFleet", "FabricBoard", "FabricReport",
    "ShardMap", "Shard", "PartitionMap",
    "partition_rows", "partition_tables", "fits_one_board",
    "FabricExchange", "ExchangeTraffic", "RemoteRowCache",
    "MigrationPlan", "RowMove", "expand_map", "shrink_map",
    "plan_migration",
]
