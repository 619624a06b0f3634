"""repro_torch.cluster -- multi-replica scale-in serving.

The port's counterpart of ``repro.cluster``. `Replica` wraps an
Engine+ServeSession on its own board (one device; on one card the boards
share it); `Router` policies (round_robin / jsq / p2c) spread a traffic
scenario's timestamped queries over the fleet; `Cluster` runs the merged
virtual-clock event loop into a `ClusterReport`; `SLAAutoscaler`
grows/shrinks the fleet on sustained p99 violation (copying params onto
the new board via `runtime/elastic.remesh_tree`); `HitRatioMonitor`
watches the tiered fast tier erode under `zipf_drift` and fires
`tiered_embedding.lfu_refresh` mid-serve.
"""
from repro_torch.cluster.autoscale import ScaleEvent, SLAAutoscaler
from repro_torch.cluster.cluster import Cluster, ClusterReport
from repro_torch.cluster.monitor import HitRatioMonitor
from repro_torch.cluster.replica import Replica, slice_devices, submesh
from repro_torch.cluster.router import (POLICIES, JoinShortestQueueRouter,
                                        PowerOfTwoRouter, RoundRobinRouter,
                                        Router, make_router)

__all__ = [
    "Cluster", "ClusterReport", "Replica", "submesh", "slice_devices",
    "Router", "RoundRobinRouter", "JoinShortestQueueRouter",
    "PowerOfTwoRouter", "make_router", "POLICIES",
    "SLAAutoscaler", "ScaleEvent", "HitRatioMonitor",
]
