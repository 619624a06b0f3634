"""repro_torch.online -- continuous training streamed into the live
serving fleets.

The port's counterpart of ``repro.online``. Three pieces close the
train -> serve loop:

  delta      the versioned update stream (`RowDelta` / `DeltaBatch`) and
             its FIFO + JSONL record/replay surface (`DeltaChannel`), in
             the reference's file format;
  trainer    `OnlineTrainer` (tables-only SGD against the planted
             teacher; dense MLPs frozen, so updates are purely row
             deltas) and `OnlineSource` (the trainer on the virtual
             clock, emitting batches on an interval schedule);
  coherence  the update -> cache protocol: invalidate or propagate every
             other copy of an updated row (`RemoteRowCache`, tiered fast
             slabs, host-tier device chunks) so a copy is bit-equal to
             the owner's current row or gone.

The serving side lives where serving lives: `ShardedFleet.run(online=,
coherence=)` applies batches at update barriers on the virtual clock,
and `Cluster.run(online=)` broadcasts them to every replica.
"""
from repro_torch.online.delta import (DeltaBatch, DeltaChannel, RowDelta,
                                      diff_tables)
from repro_torch.online.report import OnlineReport
from repro_torch.online.coherence import (MODES as COHERENCE_MODES,
                                          apply_to_remote_cache, check_mode,
                                          refresh_tiered, write_through_host)
from repro_torch.online.trainer import (OnlineSource, OnlineTrainer,
                                        expected_logloss, teacher_probs)

__all__ = [
    "RowDelta", "DeltaBatch", "DeltaChannel", "diff_tables",
    "OnlineReport",
    "OnlineTrainer", "OnlineSource", "teacher_probs", "expected_logloss",
    "COHERENCE_MODES", "check_mode", "apply_to_remote_cache",
    "refresh_tiered", "write_through_host",
]
