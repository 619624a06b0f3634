"""Collective-communication cost model — paper Sec. IV-B / IV-D-1.

Implements the latency + bandwidth model for the four CC primitives the paper
uses (all-to-all, all-reduce, reduce-scatter, all-gather), with the
lower-bound data volumes from [Chan et al. 2007] quoted in the paper:

  * all-to-all with total data volume V over n processors moves at least
    ``V * (n-1)/n`` bytes in and out of every processor;
  * all-reduce moves at least ``2 * V * (n-1)/n``  (== reduce-scatter
    followed by all-gather, each ``V*(n-1)/n``).

Time model (paper Fig. 5 — "simple latency/bandwidth model"):

  T(op, V) = latency(op) + bytes_on_wire(op, V) / bandwidth

where ``bandwidth`` is the per-processor injection bandwidth (paper: "the
bandwidth per processor will limit overall all-to-all and all-reduce
throughput, even as more processors are added").

Topology factors: the paper notes a quadratic (fully connected point-to-point)
interconnect achieves the lower bound for all-to-all, while a ring pays an
``(n-1)``-step serialization; switched fabrics add several hundred ns of
switch latency per traversal.  These are exposed as `Topology` multipliers so
the RecSpeed-vs-DGX-2 comparison and a torus fabric all fall out of one
model.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict


class CollectiveOp(str, enum.Enum):
    ALL_TO_ALL = "all_to_all"
    ALL_REDUCE = "all_reduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALL_GATHER = "all_gather"
    POINT_TO_POINT = "point_to_point"


class Topology(str, enum.Enum):
    """Interconnect topologies analyzed in the paper (Sec. VII-A)."""

    QUADRATIC = "quadratic"      # fixed point-to-point all-to-all (RecSpeed)
    SWITCHED = "switched"        # NVSwitch / Ethernet-switch fabric (DGX-2, HLS-1)
    RING = "ring"                # classic ring (well-suited to all-reduce only)
    TORUS_2D = "torus_2d"        # 2D torus (bisection-limited all-to-all)


@dataclass(frozen=True)
class Interconnect:
    """Per-processor interconnect description.

    bandwidth   : per-processor injection bandwidth, bytes/s (all links aggregated)
    base_latency: software + hardware latency floor for one collective, seconds
    topology    : link structure; determines all-to-all efficiency
    switch_hop_latency: extra latency per switch traversal (paper: ~300-500 ns)
    n_switch_hops: switch traversals per collective (DGX-2: 1; scale-out: >=2)
    """

    bandwidth: float
    base_latency: float
    topology: Topology = Topology.QUADRATIC
    switch_hop_latency: float = 0.0
    n_switch_hops: int = 0

    @property
    def latency(self) -> float:
        return self.base_latency + self.n_switch_hops * self.switch_hop_latency


def lower_bound_bytes(op: CollectiveOp, total_volume: int, n: int) -> float:
    """Per-processor bytes on the wire — the paper's [8] lower bounds.

    ``total_volume`` is V, the total payload size of the collective (bytes
    summed over all processors' inputs for all-to-all/reduce ops; the final
    gathered size for all-gather).
    """
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if op == CollectiveOp.ALL_TO_ALL:
        return total_volume / n * frac * n / n * n  # V/n sent by each to (n-1) peers
    if op == CollectiveOp.ALL_REDUCE:
        return 2.0 * total_volume * frac
    if op in (CollectiveOp.REDUCE_SCATTER, CollectiveOp.ALL_GATHER):
        return total_volume * frac
    if op == CollectiveOp.POINT_TO_POINT:
        return float(total_volume)
    raise ValueError(op)


def _all_to_all_per_proc_bytes(per_proc_payload: int, n: int) -> float:
    """Bytes each processor injects for an all-to-all where it holds
    ``per_proc_payload`` bytes destined uniformly to all n processors."""
    if n <= 1:
        return 0.0
    return per_proc_payload * (n - 1) / n


# Topology efficiency for all-to-all: fraction of the lower bound the wire
# traffic achieves (1.0 = optimal).  Paper [10]: ring is 2.3x-15x worse than
# quadratic for all-to-all; a 2D torus with W wraps sits in between (bisection
# limited).  For all-reduce all listed topologies reach the lower bound.
def all_to_all_topology_factor(topology: Topology, n: int) -> float:
    if topology in (Topology.QUADRATIC, Topology.SWITCHED):
        return 1.0
    if topology == Topology.RING:
        # Ring all-to-all: average hop distance ~ n/4 of the ring, so the
        # same byte crosses ~n/4 links vs 1 on quadratic.
        return max(1.0, n / 4.0)
    if topology == Topology.TORUS_2D:
        side = max(1, int(round(math.sqrt(n))))
        return max(1.0, side / 4.0)
    raise ValueError(topology)


@dataclass(frozen=True)
class CollectiveCost:
    op: CollectiveOp
    latency_s: float
    wire_bytes: float        # bytes through the busiest processor's links
    bandwidth_s: float       # wire_bytes / per-proc bandwidth x topo factor

    @property
    def total_s(self) -> float:
        return self.latency_s + self.bandwidth_s


def collective_time(
    op: CollectiveOp,
    per_proc_payload_bytes: float,
    n: int,
    link: Interconnect,
) -> CollectiveCost:
    """Time for one collective.

    ``per_proc_payload_bytes`` is the message size *per processor* — the unit
    the paper reports (e.g. "320KB of indices per processor", "~5.2MB per
    processor", "~2.4MB per processor all-reduce", "~60MB per processor").
    """
    if n <= 1 or per_proc_payload_bytes <= 0:
        return CollectiveCost(op, 0.0, 0.0, 0.0)
    frac = (n - 1) / n
    if op == CollectiveOp.ALL_TO_ALL:
        wire = per_proc_payload_bytes * frac
        wire *= all_to_all_topology_factor(link.topology, n)
    elif op == CollectiveOp.ALL_REDUCE:
        wire = 2.0 * per_proc_payload_bytes * frac
    elif op in (CollectiveOp.REDUCE_SCATTER, CollectiveOp.ALL_GATHER):
        wire = per_proc_payload_bytes * frac
    elif op == CollectiveOp.POINT_TO_POINT:
        wire = per_proc_payload_bytes
    else:
        raise ValueError(op)
    return CollectiveCost(op, link.latency, wire, wire / link.bandwidth)


# ---------------------------------------------------------------------------
# DLRM message sizing (paper Sec. VI-B quotes these numbers for RM2):
#   unsharded small:  indices a2a 320 KB/proc, pooled-emb a2a 64 KB/proc
#   sharded small:    unpooled-emb exchange ~5.2 MB/proc
#   training small:   dense all-reduce ~2.4 MB/proc
#   sharded large:    unpooled-emb exchange ~60 MB/proc
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DLRMMessageSizes:
    """Per-processor message sizes (bytes) for one batch step."""

    indices_a2a: float          # sparse index exchange (fwd)
    pooled_emb_a2a: float       # pooled embedding exchange (fwd, unsharded)
    unpooled_emb_exchange: float  # unpooled rows reduce-scattered (fwd, sharded)
    dense_allreduce: float      # dense grads (bwd, training)
    sparse_grad_exchange: float  # pooled grads back to owners (bwd)


def dlrm_message_sizes(
    batch_size: int,
    num_tables: int,
    lookups_per_table: int,
    embed_bytes: int,
    n: int,
    dense_param_bytes: float,
    index_bytes: int = 8,
    sharding: str = "table_wise",
) -> DLRMMessageSizes:
    """Derive the per-processor CC payloads for a DLRM step.

    Conventions (match paper Sec. VI-B numbers for RM2):
      * the global batch is ``batch_size``; each processor computes the dense
        model for its slice of ``batch_size / n`` samples;
      * indices a2a: every processor ships the indices of its batch slice for
        the (n-1)/n of tables it does not own -> payload ~= B/n * T * L * idx
        bytes ... the paper quotes the *aggregate per-processor* number
        B * T * L * idx / n. We follow the paper's convention: payload held
        per processor entering the a2a.
      * pooled-emb a2a (unsharded): each owner produced B x (T/n) pooled rows
        and redistributes over the batch dim: payload B * T/n * embed_bytes.
      * unpooled exchange (sharded): every processor holds partial pools for
        the full batch over all tables -> B * T * embed_bytes entering a
        reduce-scatter.  (This is the "many more unpooled vectors" case; with
        zero temporal locality each of B*T*L looked-up rows is distinct but
        partial pooling reduces each processor's payload to B*T rows.)
      * dense all-reduce: all dense params' grads.
    """
    b = batch_size
    t, l, e = num_tables, lookups_per_table, embed_bytes
    indices = b * t * l * index_bytes / n
    pooled = b * t * e / n
    unpooled = b * t * e          # partial pools for full batch, all tables
    sparse_grad = b * t * e / n   # pooled grads, batch-slice x all tables
    return DLRMMessageSizes(
        indices_a2a=indices,
        pooled_emb_a2a=pooled,
        unpooled_emb_exchange=unpooled,
        dense_allreduce=dense_param_bytes,
        sparse_grad_exchange=sparse_grad if sharding == "table_wise" else unpooled,
    )


# Convenience: named op set used by the HLO scraper in launch/roofline.
HLO_COLLECTIVE_OPS: Dict[str, CollectiveOp] = {
    "all-gather": CollectiveOp.ALL_GATHER,
    "all-reduce": CollectiveOp.ALL_REDUCE,
    "reduce-scatter": CollectiveOp.REDUCE_SCATTER,
    "all-to-all": CollectiveOp.ALL_TO_ALL,
    "collective-permute": CollectiveOp.POINT_TO_POINT,
}
