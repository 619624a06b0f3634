"""DLRM system performance model — paper Sec. V (the paper's primary artifact).

Computes upper-bound step time / QPS / memory utilization for distributed
DLRM inference and training (paper Algorithms 1 & 2) on a homogeneous
n-chip system, as a function of:

  * DLRM configuration (paper Table XII, `DLRMConfig`),
  * sharding strategy ("table_wise" == paper "unsharded",
                       "row_wise"  == paper "full sharding"),
  * hardware: CC latency/bandwidth/topology (`Interconnect`), random-access
    memory behaviour (`MemorySystem`), dense compute FLOP/s.

Model structure (derived from paper Sec. V-B "maximal overlap within a
batch": memory activity overlaps communications chunk-wise, but the indices
all-to-all must complete before lookups can begin, and phases that the paper
reports separately — FWD / ALLREDUCE / SPARSE-UPDATE, Fig. 12b — are serial):

  T_inference = T_idx_a2a + max(T_lookup, T_emb_exchange, T_dense_fwd)

  T_training  = T_inference                      # forward
              + max(T_dense_allreduce, T_bwd)    # allreduce pipelined w/ bwd
              + T_grad_exchange + T_row_write    # SPARSE UPDT phase

Embedding-exchange payloads per processor (paper Sec. VI-B quotes):
  unsharded fwd  : pooled rows      B*T*e/n        (64 KB small cfg @ n=8)
  sharded  fwd   : unpooled rows    B*T*L*e/n      (~5.2 MB small, ~60 MB large)
  indices  a2a   : B*T*L*4/n                       (320 KB small)
  dense allreduce: all dense-layer grads           (~2.4 MB wire small)
  unsharded bwd  : pooled grads     B*T*e/n   (all-to-all)
  sharded  bwd   : pooled grads     B*T*e     (all-gather, Alg. 2)

BEYOND-PAPER option (`row_wise_exchange="partial_pool"`): with sum pooling,
row-sharded processors can partially pool their owned rows per (sample,
table) and reduce-scatter the partial sums — wire bytes drop from
B*T*L*e/n to B*T*e*(n-1)/n, an L/n reduction (10x for RM2-small @ n=8).
The paper's model ships unpooled rows; we reproduce that faithfully as the
default and expose the optimization separately.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from dataclasses import replace as _replace

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.collectives import (
    CollectiveOp, Interconnect, Topology, all_to_all_topology_factor,
    collective_time)
from repro_torch.core.memsys import (
    MemorySystem, recspeed_hbm2e, recspeed_sweep_hbm2e, v100_hbm2,
    xeon_ddr4_6ch)


# ---------------------------------------------------------------------------
# System descriptions
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SystemConfig:
    """A homogeneous n-chip system (paper Sec. VI-A)."""

    name: str
    n_chips: int
    compute_flops: float              # dense FLOP/s per chip (fp16/bf16)
    a2a: Interconnect                 # all-to-all / all-gather characteristics
    allreduce: Interconnect           # all-reduce characteristics
    mem: MemorySystem                 # per-chip attached (bulk-tier) memory
    index_bytes: int = 4              # paper: 320 KB = B*T*L*4/n
    elem_bytes: int = 2               # fp16 everywhere (paper Sec. V-A)
    # Optional fast memory tier (paper Sec. VII-A hybrid HBM+DDR4): lookups
    # that hit the planner's hot placement are serviced here, the rest by
    # `mem`. None = single-tier system (hit_ratio is then ignored).
    fast_mem: Optional[MemorySystem] = None

    def with_cc(self, latency_s: float, bandwidth: float) -> "SystemConfig":
        """Sweep helper: same system, different CC latency/bandwidth."""
        a2a = Interconnect(bandwidth, latency_s, self.a2a.topology)
        ar = Interconnect(bandwidth, latency_s, self.allreduce.topology)
        return _replace(self, a2a=a2a, allreduce=ar)


def recspeed_system() -> SystemConfig:
    """Paper Table XIV: 16 chips, 1 us / 1000 GB/s CC, 200 TFLOPS,
    6 stacks HBM2E @ 3000 MHz (+ 256 GB DDR4 bulk, used by the planner)."""
    link = Interconnect(1000e9, 1e-6, Topology.QUADRATIC)
    return SystemConfig("recspeed", 16, 200e12, link, link, recspeed_hbm2e())


def dgx2_system() -> SystemConfig:
    """Paper Table XV: 16 x V100, 150 GB/s/chip, measured CC latencies
    (Table VI: all-reduce ~50 us, all-gather/all-to-all ~100 us)."""
    a2a = Interconnect(150e9, 100e-6, Topology.SWITCHED)
    ar = Interconnect(150e9, 50e-6, Topology.SWITCHED)
    return SystemConfig("dgx-2", 16, 125e12, a2a, ar, v100_hbm2())


def recspeed_hybrid_system() -> SystemConfig:
    """Paper Sec. VII-A hybrid memory: per-chip HBM2E fast tier serving the
    planner's hot placement, 256 GB DDR4 bulk tier serving cold rows. The
    cache-hit-ratio term (`hit_ratio` on `breakdown`) splits lookup traffic
    between the tiers."""
    base = recspeed_system()
    return _replace(base, name="recspeed-hybrid",
                    mem=xeon_ddr4_6ch(256e9), fast_mem=base.mem)


def sweep_system(latency_s: float, bandwidth: float, n_chips: int = 8) -> SystemConfig:
    """Paper Table XIII: 8 chips, 200 TFLOPS, 6 x HBM2E @ 2400; CC swept."""
    link = Interconnect(bandwidth, latency_s, Topology.QUADRATIC)
    return SystemConfig(f"sweep-l{latency_s*1e6:g}us-b{bandwidth/1e9:g}",
                        n_chips, 200e12, link, link, recspeed_sweep_hbm2e())


# ---------------------------------------------------------------------------
# DLRM dense-parameter account
# ---------------------------------------------------------------------------
def dense_param_count(cfg: DLRMConfig) -> int:
    n = 0
    prev = cfg.num_dense
    for w in cfg.bot_mlp_dims:
        n += prev * w + w
        prev = w
    prev = cfg.top_mlp_in
    for w in cfg.top_mlp:
        n += prev * w + w
        prev = w
    return n


# ---------------------------------------------------------------------------
# Step breakdown
# ---------------------------------------------------------------------------
@dataclass
class StepBreakdown:
    """All times in seconds; *per step* (= one query of cfg.batch_size)."""

    system: str
    config: str
    mode: str                          # "inference" | "training"
    t_idx_a2a: float = 0.0
    t_lookup: float = 0.0
    t_emb_exchange: float = 0.0
    t_dense_fwd: float = 0.0
    t_fwd: float = 0.0
    t_bwd_compute: float = 0.0
    t_dense_allreduce: float = 0.0
    t_grad_exchange: float = 0.0
    t_row_write: float = 0.0
    t_step: float = 0.0
    notes: Dict[str, float] = field(default_factory=dict)

    @property
    def qps(self) -> float:
        return 1.0 / self.t_step if self.t_step > 0 else float("inf")

    @property
    def mem_util(self) -> float:
        """Fraction of the step the memory system is busy doing lookups —
        matches the paper's Table XVI 'Mem. Util' definition."""
        return self.t_lookup / self.t_step if self.t_step > 0 else 0.0

    @property
    def allreduce_frac(self) -> float:
        return (max(self.t_dense_allreduce, self.t_bwd_compute) / self.t_step
                if self.t_step > 0 else 0.0)

    def phase_fractions(self) -> Dict[str, float]:
        """Paper Fig. 12b/13b: FWD / ALLREDUCE / SPARSE-UPDT shares."""
        fwd = self.t_fwd
        ar = max(self.t_dense_allreduce, self.t_bwd_compute)
        sp = self.t_grad_exchange + self.t_row_write
        tot = max(self.t_step, 1e-30)
        return {"fwd": fwd / tot, "allreduce": ar / tot, "sparse_updt": sp / tot}


def _payloads(cfg: DLRMConfig, sys: SystemConfig) -> Dict[str, float]:
    b, t, l = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    e = cfg.embed_dim * sys.elem_bytes
    n = sys.n_chips
    return {
        "indices": b * t * l * sys.index_bytes / n,
        "pooled": b * t * e / n,
        "unpooled": b * t * l * e / n,
        "partial_pool": b * t * e,          # reduce-scatter payload per proc
        "pooled_all": b * t * e,            # all-gather total (bwd, sharded)
        "lookup_bytes": b * t * l * e / n,  # per-chip memory traffic
        # gradients are accumulated/all-reduced in fp32 (the paper's ~2.4 MB
        # quote for RM2's ~600k dense params matches 4 B/elem, not fp16)
        "dense_grad": dense_param_count(cfg) * 4,
    }


def _tiered_access_time(bytes_moved: float, access_bytes: int,
                        sys: SystemConfig, hit_ratio: float,
                        write: bool = False) -> float:
    """Random-access service time with the cache-hit-ratio term: `hit_ratio`
    of the traffic is serviced by the fast tier, the rest by the bulk tier.
    Single-tier systems (fast_mem=None) ignore hit_ratio."""
    rate = (MemorySystem.random_write_bytes_per_s if write
            else MemorySystem.random_access_bytes_per_s)
    t_bulk = bytes_moved / rate(sys.mem, access_bytes)
    if sys.fast_mem is None or hit_ratio <= 0.0:
        return t_bulk
    h = min(hit_ratio, 1.0)
    return (h * bytes_moved / rate(sys.fast_mem, access_bytes)
            + (1.0 - h) * t_bulk)


# Measured kernel names that can replace the modeled lookup/pool term, in
# priority order: the fused serve megakernel subsumes the bag kernels.
_LOOKUP_KERNELS = ("fused_bag_interactions", "cached_embedding_bag",
                   "embedding_bag")


def inference_breakdown(
    cfg: DLRMConfig,
    sys: SystemConfig,
    row_wise_exchange: str = "unpooled",   # "unpooled" (paper) | "partial_pool"
    hit_ratio: float = 0.0,                # planner placement fast-tier share
    calibration=None,                      # measured kernel_times artifact
) -> StepBreakdown:
    """Paper Eq./Sec. V-B inference step model. With `calibration` (a path
    to / dict of a calibration artifact carrying a `kernel_times` section,
    see `core.calibration`), the modeled lookup term is
    replaced by the MEASURED per-call time of the bag-family kernel that
    actually runs (`_LOOKUP_KERNELS` priority: the fused serve megakernel
    wins when present) and the modeled/measured delta is reported in
    `notes` — every measured entry also lands there as `kernel_us_<name>`.
    """
    p = _payloads(cfg, sys)
    n = sys.n_chips
    bd = StepBreakdown(sys.name, cfg.name, "inference")

    bd.t_idx_a2a = collective_time(
        CollectiveOp.ALL_TO_ALL, p["indices"], n, sys.a2a).total_s
    bd.t_lookup = _tiered_access_time(
        p["lookup_bytes"], cfg.embed_dim * sys.elem_bytes, sys, hit_ratio)

    if cfg.sharding == "table_wise":
        bd.t_emb_exchange = collective_time(
            CollectiveOp.ALL_TO_ALL, p["pooled"], n, sys.a2a).total_s
    elif row_wise_exchange == "unpooled":      # paper-faithful full sharding
        bd.t_emb_exchange = collective_time(
            CollectiveOp.ALL_TO_ALL, p["unpooled"], n, sys.a2a).total_s
    else:                                      # beyond-paper: partial pooling
        bd.t_emb_exchange = collective_time(
            CollectiveOp.REDUCE_SCATTER, p["partial_pool"], n, sys.a2a).total_s

    bd.t_dense_fwd = (cfg.flops_per_sample() * cfg.batch_size / n
                      / sys.compute_flops)

    if calibration is not None:
        from repro_torch.core.calibration import kernel_times_from
        kt = kernel_times_from(calibration)
        for name, us in kt.items():
            bd.notes[f"kernel_us_{name}"] = us
        measured = next((kt[k] for k in _LOOKUP_KERNELS if k in kt), None)
        if measured is not None:
            t_meas = measured * 1e-6
            bd.notes["t_lookup_modeled_s"] = bd.t_lookup
            bd.notes["t_lookup_delta_s"] = t_meas - bd.t_lookup
            bd.t_lookup = t_meas
        if "interactions" in kt:
            # delta-only: t_dense_fwd also covers the MLP flops, so the
            # interaction kernel's measured time informs but cannot
            # replace it
            bd.notes["interactions_measured_s"] = kt["interactions"] * 1e-6
            bd.notes["interactions_delta_vs_dense_fwd_s"] = (
                kt["interactions"] * 1e-6 - bd.t_dense_fwd)

    bd.t_fwd = bd.t_idx_a2a + max(bd.t_lookup, bd.t_emb_exchange, bd.t_dense_fwd)
    bd.t_step = bd.t_fwd
    return bd


def training_breakdown(
    cfg: DLRMConfig,
    sys: SystemConfig,
    row_wise_exchange: str = "unpooled",
    overlap_allreduce: bool = True,
    hit_ratio: float = 0.0,
) -> StepBreakdown:
    p = _payloads(cfg, sys)
    n = sys.n_chips
    bd = inference_breakdown(cfg, sys, row_wise_exchange, hit_ratio)
    bd.mode = "training"

    # backward dense compute ~ 2x forward FLOPs (dgrad + wgrad)
    bd.t_bwd_compute = 2.0 * bd.t_dense_fwd
    bd.t_dense_allreduce = collective_time(
        CollectiveOp.ALL_REDUCE, p["dense_grad"], n, sys.allreduce).total_s

    # SPARSE UPDT phase (paper Fig. 12b): pooled-grad exchange + row writes.
    if cfg.sharding == "table_wise":
        bd.t_grad_exchange = collective_time(
            CollectiveOp.ALL_TO_ALL, p["pooled"], n, sys.a2a).total_s
    else:
        # Alg. 2: all-gather of pooled grads so every row owner sees the
        # full batch's gradients.
        bd.t_grad_exchange = collective_time(
            CollectiveOp.ALL_GATHER, p["pooled_all"], n, sys.a2a).total_s
    # Originally-looked-up rows are buffered on-chip (paper Sec. V-B), so the
    # update is a write-only stream of B*T*L/n rows (hot-row writes land in
    # the fast tier under a placed plan — same split as the lookups).
    bd.t_row_write = _tiered_access_time(
        p["lookup_bytes"], cfg.embed_dim * sys.elem_bytes, sys, hit_ratio,
        write=True)

    ar_phase = (max(bd.t_dense_allreduce, bd.t_bwd_compute) if overlap_allreduce
                else bd.t_dense_allreduce + bd.t_bwd_compute)
    bd.t_step = bd.t_fwd + ar_phase + bd.t_grad_exchange + bd.t_row_write
    return bd


def breakdown(cfg: DLRMConfig, sys: SystemConfig, mode: str,
              row_wise_exchange: str = "unpooled",
              hit_ratio: float = 0.0) -> StepBreakdown:
    if mode == "inference":
        return inference_breakdown(cfg, sys, row_wise_exchange, hit_ratio)
    if mode == "training":
        return training_breakdown(cfg, sys, row_wise_exchange,
                                  hit_ratio=hit_ratio)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Executed-schedule model: micro-batch pipelining (repro.parallel.build_step)
# ---------------------------------------------------------------------------
def _collective_s(op: CollectiveOp, payload: float, n: int,
                  link: Interconnect) -> float:
    return collective_time(op, payload, n, link).total_s


def pipelined_breakdown(
    cfg: DLRMConfig,
    sys: SystemConfig,
    mode: str = "inference",
    pipeline_depth: int = 1,
    row_wise_exchange: str = "unpooled",
    hit_ratio: float = 0.0,
    compress_grads: bool = False,
) -> StepBreakdown:
    """Step time of the EXECUTED schedule (`repro.parallel.build_step`),
    not the paper's maximal-overlap upper bound (`breakdown`).

    depth=1 models the serial schedule the pre-refactor step factories ran:
    index a2a -> lookup -> embedding exchange -> dense compute, strictly in
    order. depth=k splits the batch into k micro-batches and runs the
    two-stage software pipeline build_step emits — stage E (index a2a +
    lookup + embedding exchange) of micro-batch i+1 overlapping stage C
    (dense compute) of micro-batch i; training adds the per-micro-batch
    grad routing as a third overlapped stage, then the dense all-reduce
    (int8-compressed when `compress_grads`) and row writes serially.

    Per-micro-batch collective payloads shrink k-fold but the LATENCY term
    is paid k times — the optimal depth trades overlap winnings against
    latency replay (see `optimal_pipeline_depth`).

    Field semantics differ from `breakdown` to keep the derived views
    (`phase_fractions`, `allreduce_frac`) consistent: `t_fwd` is the whole
    overlapped pipeline region — for training that INCLUDES backward
    compute and per-micro-batch grad routing, so `t_bwd_compute` and
    `t_grad_exchange` are reported as 0 on the breakdown (their
    per-micro-batch values live in notes) and the training phases are
    {pipeline region, dense all-reduce, row writes}.

    notes: pipeline_depth, per-micro-batch stage times, and
    `pipeline_overlap` — the seconds hidden vs. the depth=1 serial schedule
    at the same depth-independent work.
    """
    k = max(1, int(pipeline_depth))
    p = _payloads(cfg, sys)
    n = sys.n_chips
    e_bytes = cfg.embed_dim * sys.elem_bytes
    bd = StepBreakdown(sys.name, cfg.name, mode)

    # per-micro-batch stage pieces (payload / k; latency NOT divided)
    t_idx = _collective_s(CollectiveOp.ALL_TO_ALL, p["indices"] / k, n, sys.a2a)
    t_lookup = _tiered_access_time(p["lookup_bytes"] / k, e_bytes, sys,
                                   hit_ratio)
    if cfg.sharding == "table_wise":
        t_exch = _collective_s(CollectiveOp.ALL_TO_ALL, p["pooled"] / k, n,
                               sys.a2a)
    elif row_wise_exchange == "unpooled":
        t_exch = _collective_s(CollectiveOp.ALL_TO_ALL, p["unpooled"] / k, n,
                               sys.a2a)
    else:
        t_exch = _collective_s(CollectiveOp.REDUCE_SCATTER,
                               p["partial_pool"] / k, n, sys.a2a)
    t_fwd_flops = (cfg.flops_per_sample() * cfg.batch_size / n
                   / sys.compute_flops) / k

    stage_e = t_idx + t_lookup + t_exch            # exchange stage per mb
    if mode == "inference":
        stage_c = t_fwd_flops                      # dense fwd per mb
        t_pipe = stage_e + stage_c + (k - 1) * max(stage_e, stage_c)
        serial = k * (stage_e + stage_c)
        bd.t_idx_a2a, bd.t_lookup, bd.t_emb_exchange = (
            k * t_idx, k * t_lookup, k * t_exch)
        bd.t_dense_fwd = k * t_fwd_flops
        bd.t_fwd = t_pipe
        bd.t_step = t_pipe
    elif mode == "training":
        stage_c = 3.0 * t_fwd_flops                # dense fwd+bwd per mb
        # grad routing per micro-batch (third pipeline stage)
        if cfg.sharding == "table_wise":
            t_gexch = _collective_s(CollectiveOp.ALL_TO_ALL, p["pooled"] / k,
                                    n, sys.a2a)
        else:
            t_gexch = _collective_s(CollectiveOp.ALL_GATHER,
                                    p["pooled_all"] / k, n, sys.a2a)
        t_pipe = (stage_e + stage_c + t_gexch
                  + (k - 1) * max(stage_e, stage_c, t_gexch))
        serial = k * (stage_e + stage_c + t_gexch)
        grad_payload = p["dense_grad"]
        if compress_grads:
            # int8 payload + fp32 absmax scale per 256-elem block (4x wire
            # reduction on the fp32 gradient all-reduce)
            grad_payload = grad_payload * (1.0 + 4.0 / 256.0) / 4.0
        t_ar = _collective_s(CollectiveOp.ALL_REDUCE, grad_payload, n,
                             sys.allreduce)
        t_write = _tiered_access_time(p["lookup_bytes"], e_bytes, sys,
                                      hit_ratio, write=True)
        bd.t_idx_a2a, bd.t_lookup, bd.t_emb_exchange = (
            k * t_idx, k * t_lookup, k * t_exch)
        bd.t_dense_fwd = k * t_fwd_flops
        # bwd compute + grad routing are INSIDE the pipelined t_fwd region;
        # zero here so phase_fractions/allreduce_frac don't double-count
        # (per-micro-batch values are in notes).
        bd.t_bwd_compute = 0.0
        bd.t_grad_exchange = 0.0
        bd.t_dense_allreduce = t_ar
        bd.t_row_write = t_write
        bd.t_fwd = t_pipe
        bd.t_step = t_pipe + t_ar + t_write
        bd.notes["t_grad_exchange_mb"] = t_gexch
        bd.notes["t_bwd_compute_mb"] = 2.0 * t_fwd_flops
    else:
        raise ValueError(mode)

    bd.notes.update({
        "pipeline_depth": float(k),
        "t_stage_exchange_mb": stage_e,
        "t_stage_compute_mb": stage_c,
        "pipeline_overlap": serial - t_pipe,
    })
    return bd


# ---------------------------------------------------------------------------
# Cross-board fabric model (repro.fabric): the paper's interconnect terms
# applied at BOARD granularity instead of chip granularity
# ---------------------------------------------------------------------------
def fabric_link(latency_us: float = 1.0, bandwidth_gbs: float = 100.0,
                topology: Topology = Topology.QUADRATIC,
                switch_hop_latency_ns: float = 0.0,
                n_switch_hops: int = 0) -> Interconnect:
    """An inter-board fabric link in bench/CLI units (us, GB/s). The same
    `Interconnect` abstraction the chip-level CC model uses — the paper's
    scale-in argument is that latency/bandwidth/topology bound throughput
    identically at every level of the hierarchy."""
    return Interconnect(bandwidth_gbs * 1e9, latency_us * 1e-6, topology,
                       switch_hop_latency_ns * 1e-9, n_switch_hops)


def fabric_exchange_time(bytes_out: float, bytes_in: float, n_boards: int,
                         link: Interconnect) -> float:
    """Seconds one query-owner board spends on the inter-board embedding
    exchange: index scatter to the owner boards (`bytes_out`) and pooled
    vectors gathered back (`bytes_in`).

    Latency is paid twice (request + response round) and the payloads ride
    the all-to-all topology factor (a ring/torus fabric forwards the same
    byte over multiple links). `bytes_out`/`bytes_in` are the exact wire
    payloads the caller accounts from the partition map — lookups whose
    owner IS the query board (or that hit the remote-row cache) never
    reach this term."""
    if n_boards <= 1 or (bytes_out <= 0 and bytes_in <= 0):
        return 0.0
    factor = all_to_all_topology_factor(link.topology, n_boards)
    return (2.0 * link.latency
            + factor * (bytes_out + bytes_in) / link.bandwidth)


def repartition_time(per_board_send_bytes: Sequence[float],
                     per_board_recv_bytes: Sequence[float],
                     link: Interconnect) -> float:
    """Seconds a live re-partition stalls the fleet: boards stream their
    migrating row ranges point-to-point over the same fabric link queries
    ride, all boards in parallel, so the wall time is bounded by the
    BUSIEST endpoint (its send + receive bytes serialized through its one
    port) plus one request/ack latency round. No topology factor: a
    migration is a handful of long point-to-point streams, not an
    all-to-all — bandwidth, not fan-out, is the constraint."""
    send = [max(0.0, float(b)) for b in per_board_send_bytes]
    recv = [max(0.0, float(b)) for b in per_board_recv_bytes]
    if len(send) != len(recv):
        raise ValueError(
            f"per-board send/recv must align, got {len(send)}/{len(recv)}")
    busiest = max((s + r for s, r in zip(send, recv)), default=0.0)
    if busiest <= 0:
        return 0.0
    return 2.0 * link.latency + busiest / link.bandwidth


def sharded_query_bound(cfg: DLRMConfig, sys: SystemConfig, n_boards: int,
                        link: Interconnect, remote_miss_fraction: float,
                        ) -> StepBreakdown:
    """Upper-bound step time for ONE query served by a sharded fleet: the
    single-board inference breakdown plus the inter-board exchange for the
    `remote_miss_fraction` of lookups that neither the local shard nor the
    remote-row cache services: the link-latency sensitivity of the
    paper's Fig. 9, one level up."""
    bd = inference_breakdown(cfg, sys)
    f = min(max(float(remote_miss_fraction), 0.0), 1.0)
    b, t, l = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    bytes_out = f * b * t * l * sys.index_bytes
    bytes_in = f * b * t * cfg.embed_dim * sys.elem_bytes
    t_fabric = fabric_exchange_time(bytes_out, bytes_in, n_boards, link)
    bd.notes["t_fabric"] = t_fabric
    bd.notes["fabric_bytes_per_query"] = bytes_out + bytes_in
    bd.t_step = bd.t_fwd + t_fabric
    return bd


# ---------------------------------------------------------------------------
# Host chunk tier model (repro.hoststore): the paper's memory-system
# analysis extended one level DOWN — PCIe/host-DRAM terms for weights that
# do not fit device memory at all (Gupta et al.'s DGX-2 host-spill cliff)
# ---------------------------------------------------------------------------
def host_link(latency_us: float = 10.0, bandwidth_gbs: float = 16.0,
              calibration=None) -> Interconnect:
    """The host<->device (PCIe) link in bench/CLI units. Defaults model a
    PCIe 4.0 x16 port (~16 GB/s effective, ~10 us DMA setup). `calibration`
    is an optional measured-artifact override — a path to (or dict from) a
    calibration JSON whose "host_link" entry carries measured
    latency_us / bandwidth_gbs (the ROADMAP real-hardware hook)."""
    if calibration is not None:
        from repro_torch.core.calibration import load_calibration
        hl = load_calibration(calibration).get("host_link", {})
        latency_us = float(hl.get("latency_us", latency_us))
        bandwidth_gbs = float(hl.get("bandwidth_gbs", bandwidth_gbs))
    return Interconnect(bandwidth_gbs * 1e9, latency_us * 1e-6,
                        Topology.QUADRATIC)


def host_swap_time(bytes_moved: float, link: Interconnect,
                   n_transfers: int = 1) -> float:
    """Seconds to move `bytes_moved` of chunk traffic over the host link as
    `n_transfers` DMA descriptors (one per faulted/written-back chunk: the
    per-chunk setup latency is what makes tiny chunks lose even though
    their bytes are minimal)."""
    if bytes_moved <= 0:
        return 0.0
    return max(1, int(n_transfers)) * link.latency \
        + float(bytes_moved) / link.bandwidth


def hoststore_query_bound(cfg: DLRMConfig, sys: SystemConfig,
                          link: Interconnect, device_hit_ratio: float,
                          chunk_rows: int, pipeline_depth: int = 1,
                          chunks_per_query: Optional[float] = None,
                          ) -> StepBreakdown:
    """Upper-bound step time for one query served through the host chunk
    tier: the single-board inference breakdown plus the swap stall left
    after `pipeline_depth`-deep overlap (micro-batch i+1's chunk faults
    hide under micro-batch i's compute window; micro-batch 0's never do).

    `device_hit_ratio` is the fraction of lookups resolved on device (hot
    slab + already-resident chunks); the rest fault `chunks_per_query`
    chunks (default: one chunk per cold lookup, capped at the table set's
    total chunk count — the cold-start worst case). Strictly monotone in
    link bandwidth while any bytes move: the PCIe cliff the bench sweeps."""
    bd = inference_breakdown(cfg, sys, hit_ratio=device_hit_ratio)
    b, t, l = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    h = min(max(float(device_hit_ratio), 0.0), 1.0)
    cr = max(1, int(chunk_rows))
    if chunks_per_query is None:
        chunks_per_query = (1.0 - h) * b * t * l
    max_chunks = t * math.ceil(cfg.rows_per_table / cr)
    chunks = min(float(chunks_per_query), float(max_chunks))
    swap_bytes = chunks * cr * cfg.embed_dim * sys.elem_bytes
    t_swap = host_swap_time(swap_bytes, link,
                            n_transfers=max(1, int(math.ceil(chunks))))
    k = max(1, int(pipeline_depth))
    per_mb = t_swap / k
    window = bd.t_fwd / k
    stall = per_mb + (k - 1) * max(0.0, per_mb - window)
    bd.notes.update({
        "t_host_swap": t_swap,
        "host_stall_s": stall,
        "host_swap_bytes": swap_bytes,
        "host_chunks_per_query": chunks,
        "host_pipeline_depth": float(k),
    })
    bd.t_step = bd.t_fwd + stall
    return bd


HOSTSTORE_CHUNK_GRID: Tuple[int, ...] = (4, 8, 16, 32, 64)


def choose_hoststore_config(cfg: DLRMConfig, link: Interconnect,
                            cache_budget_bytes: int,
                            sys: Optional[SystemConfig] = None,
                            chunk_rows_grid: Iterable[int] = HOSTSTORE_CHUNK_GRID,
                            device_hit_ratio: float = 0.5,
                            pipeline_depth: int = 2,
                            ) -> Tuple[int, Dict[int, float]]:
    """Planner-side chunk-size pick: sweep `hoststore_query_bound` over the
    chunk grid and return (best_chunk_rows, {chunk_rows: t_step}).

    The tradeoff the sweep resolves: small chunks move few bytes but pay a
    DMA-setup latency per fault; large chunks amortize setup but drag whole
    neighborhoods across PCIe and cut the slot count the budget affords. A
    grid point is infeasible when the modeled per-query chunk working set
    exceeds the slots the cache budget buys at that chunk size."""
    sys = sys if sys is not None else recspeed_system()
    b, t, l = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    h = min(max(float(device_hit_ratio), 0.0), 1.0)
    row_bytes = cfg.embed_dim * sys.elem_bytes
    sweep: Dict[int, float] = {}
    for cr in chunk_rows_grid:
        cr = max(1, min(int(cr), cfg.rows_per_table))
        slots = cache_budget_bytes // (cr * row_bytes)
        working_set = min((1.0 - h) * b * t * l,
                          t * math.ceil(cfg.rows_per_table / cr))
        if slots < max(1.0, working_set):
            continue   # one batch's chunks would not fit the cache
        sweep[cr] = hoststore_query_bound(
            cfg, sys, link, h, cr, pipeline_depth).t_step
    if not sweep:
        # nothing feasible at this budget: smallest chunks minimize the
        # forced overcommit and the runtime working-set check will report
        fallback = max(1, min(int(c) for c in chunk_rows_grid))
        return fallback, {}
    best = min(sweep, key=sweep.get)
    return best, sweep


PIPELINE_DEPTHS: Tuple[int, ...] = (1, 2, 4, 8)


def optimal_pipeline_depth(
    cfg: DLRMConfig,
    sys: SystemConfig,
    mode: str = "inference",
    depths: Iterable[int] = PIPELINE_DEPTHS,
    row_wise_exchange: str = "unpooled",
    hit_ratio: float = 0.0,
    compress_grads: bool = False,
) -> Tuple[int, Dict[int, float]]:
    """Sweep `pipelined_breakdown` over micro-batch depths; returns
    (best_depth, {depth: t_step_s}). The planner threads the winner into
    `PlanReport.pipeline_depth` so the engine executes it."""
    sweep: Dict[int, float] = {}
    for k in depths:
        if cfg.batch_size % (k * sys.n_chips):
            continue   # per-device batch must split into k micro-batches
        sweep[k] = pipelined_breakdown(
            cfg, sys, mode, k, row_wise_exchange, hit_ratio,
            compress_grads).t_step
    if not sweep:
        sweep[1] = pipelined_breakdown(
            cfg, sys, mode, 1, row_wise_exchange, hit_ratio,
            compress_grads).t_step
    best = min(sweep, key=sweep.get)
    return best, sweep


# ---------------------------------------------------------------------------
# Sweeps (paper Figs. 8-13)
# ---------------------------------------------------------------------------
LATENCY_GRID_US: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0, 6.0, 8.0, 10.0)
BANDWIDTH_GRID_GBS: Tuple[float, ...] = (100.0, 200.0, 400.0, 600.0, 800.0, 1000.0)


def cc_sweep(
    cfg: DLRMConfig,
    mode: str,
    latencies_us: Iterable[float] = LATENCY_GRID_US,
    bandwidths_gbs: Iterable[float] = BANDWIDTH_GRID_GBS,
    n_chips: int = 8,
    row_wise_exchange: str = "unpooled",
) -> List[Dict[str, float]]:
    """Paper Figs. 8 (inference) / 11 (training): QPS over the CC grid."""
    rows = []
    for lat in latencies_us:
        for bw in bandwidths_gbs:
            sys = sweep_system(lat * 1e-6, bw * 1e9, n_chips)
            bd = breakdown(cfg, sys, mode, row_wise_exchange)
            rows.append({
                "latency_us": lat, "bandwidth_gbs": bw, "qps": bd.qps,
                "t_step_us": bd.t_step * 1e6, "mem_util": bd.mem_util,
                **{f"frac_{k}": v for k, v in bd.phase_fractions().items()
                   if mode == "training"},
            })
    return rows


def latency_sensitivity(cfg: DLRMConfig, mode: str = "inference",
                        bandwidth_gbs: float = 1000.0,
                        n_chips: int = 8) -> Dict[str, float]:
    """Paper Fig. 9: QPS drop from best (0.5 us) to worst (10 us) latency."""
    best = breakdown(cfg, sweep_system(0.5e-6, bandwidth_gbs * 1e9, n_chips), mode)
    worst = breakdown(cfg, sweep_system(10e-6, bandwidth_gbs * 1e9, n_chips), mode)
    return {"qps_best": best.qps, "qps_worst": worst.qps,
            "drop": best.qps / worst.qps}


def sharding_penalty(cfg_unshard: DLRMConfig, cfg_shard: DLRMConfig,
                     latency_us: float, bandwidth_gbs: float,
                     mode: str = "inference", n_chips: int = 8,
                     row_wise_exchange: str = "unpooled") -> float:
    """Paper Fig. 10: QPS(unsharded) / QPS(sharded) at one CC point."""
    sys = sweep_system(latency_us * 1e-6, bandwidth_gbs * 1e9, n_chips)
    u = breakdown(cfg_unshard, sys, mode)
    s = breakdown(cfg_shard, sys, mode, row_wise_exchange)
    return u.qps / s.qps


# ---------------------------------------------------------------------------
# Paper Tables XVI / XVII reference values (for validation)
# ---------------------------------------------------------------------------
PAPER_TABLE_XVI = {  # inference: (RecSpeed QPS, mem util, DGX-2 QPS, speedup)
    "dlrm-rm2-small-unsharded": (300e3, 0.67, 4.9e3, 62),
    "dlrm-rm2-small-sharded": (207e3, 0.47, 4.5e3, 46),
    "dlrm-rm2-large-unsharded": (56e3, 0.93, 4.7e3, 12),
    "dlrm-rm2-large-sharded": (30e3, 0.50, 2.1e3, 14),
}
PAPER_TABLE_XVII = {  # training: (RecSpeed QPS, allred frac, DGX-2 QPS, speedup)
    "dlrm-rm2-small-unsharded": (99e3, 0.33, 2.2e3, 45),
    "dlrm-rm2-small-sharded": (83e3, 0.28, 2.1e3, 39),
    "dlrm-rm2-large-unsharded": (25e3, 0.09, 2.0e3, 12),
    "dlrm-rm2-large-sharded": (16e3, 0.06, 1.2e3, 13),
}
