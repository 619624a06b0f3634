"""Engine: one session API from config -> plan -> step -> serve or train.

    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine

    eng = Engine(get_dlrm("dlrm-rm2-small-unsharded"), plan="auto",
                 alpha=1.05)                                # on the card
    serve = eng.serve_session(max_batch_queries=4, max_wait_ms=2.0)
    report = serve.run_open_loop(n_queries=200, qps=400.0, sla_ms=50.0)

    train = eng.train_session(ckpt_dir="ckpt")
    train.run(100)

``plan=`` accepts "none" (execute cfg.sharding as-is), "auto" (profile
the step-indexed stream and run the placement planner) or a concrete
``ShardingPlan`` (reconciled against the device count). A placed plan
serves through the tiered exchange: fast and bulk table groups, fused
into one kernel launch per micro-batch. Under plan="none" a table-wise
config serves through the fused kernel too; a row-wise config ("full
sharding", ``dlrm-rm2-*-sharded``) serves composed through the row-wise
exchange in the wire mode ``exchange=`` names, as the reference does on
one device:

    eng = Engine(get_dlrm("dlrm-rm2-small-sharded"), exchange="unpooled")
 The serve step's pipeline depth
is the planner's, resolved per flushed batch shape, unless
``pipeline_depth`` pins it; a train step's is the planner's training
depth under plan="auto", else 1.

``host_capacity_mb`` turns the host chunk tier on (``repro_torch.
hoststore``): the full weights stay in host memory, a hot slab and a
chunk cache fill the device budget, and chunks swap in ahead of every
step, so a model bigger than the card serves and trains:

    eng = Engine(get_dlrm("dlrm-rm2-large-unsharded"),
                 host_capacity_mb=40960, alpha=1.05)
    serve = eng.serve_session(max_batch_queries=1)

An LM config (``configs.get_arch``) takes plan="none" and builds the LM
substrate's training session, AdamW over any of the ten archs:

    eng = Engine(get_arch("internlm2-1.8b"), lr=3e-4)
    train = eng.train_session(batch=8, seq=128, schedule_steps=30)

``sharded_fleet(n_boards=...)`` builds the sharded fabric fleet
(``repro_torch.fabric``): boards that together hold one partitioned table
set, on the engine's device.

The port serves and trains DLRM, and trains the LM, on one device.
Options of the reference's ``Engine`` that it does not carry (a mesh and
more devices: ROADMAP A6b) raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.configs.base import DLRMConfig, ModelConfig
from repro_torch.core import perf_model
from repro_torch.core.planner import ShardingPlan
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.engine.planning import (PlanReport, build_auto_plan,
                                         resolve_depth_for_batch)
from repro_torch.engine.serving import ServeSession
from repro_torch.engine.training import (HOST_TIER_CKPT, LMTrainSession,
                                        TrainSession)
from repro_torch.hoststore import HostTieredExchange, build_host_exchange
from repro_torch.parallel.plan import reconcile_plan_with_mesh

PlanArg = Union[None, str, ShardingPlan]

# The row-wise wire modes (the reference's ``RowWiseExchange``).
_ROW_WISE_EXCHANGES = ("partial_pool", "unpooled")
# The reference's default mesh axes of the embedding distribution.
_AXIS = ("data", "model")


def _check_lm(cfg, plan, pipeline_depth, compress_grads, dp_axes,
              host_capacity_mb) -> None:
    """The reference's refusals of DLRM-only options for an LM config."""
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"cfg must be a DLRMConfig or a ModelConfig, got "
                        f"{type(cfg).__name__}")
    if plan not in (None, "none"):
        raise ValueError("plan placement is DLRM-only; LM configs take "
                         "plan='none'")
    if compress_grads or pipeline_depth not in (None, 1):
        raise ValueError("pipeline_depth/compress_grads are DLRM-only")
    if dp_axes:
        raise ValueError("dp_axes is DLRM-only (the LM substrate has its "
                         "own sharding rules)")
    if host_capacity_mb is not None:
        raise ValueError("host_capacity_mb (the host chunk tier) is "
                         "DLRM-only")


class Engine:
    """Session factory over one DLRM or LM config on one device.

    Parameters
    ----------
    cfg            : DLRMConfig, or an LM ModelConfig (plan="none", no
                     pipeline depth, host tier, dp_axes or compressed
                     grads: those are DLRM-only and raise ValueError, as
                     in the reference).
    plan           : "none" | "auto" | ShardingPlan (see module doc).
    fast_mb        : fast-tier capacity (MiB) for plan="auto"; the default
                     fits ~half the tables, so the placement is MIXED.
    profile_batches: batches of the stream the auto plan's profile counts.
    fused_serve    : "auto" serves through the fused gather -> pool ->
                     interaction kernel whenever the exchange is local;
                     "off" forces the composed path. The choice is recorded
                     on ``ServeSession.serve_kernel`` and on the plan report.
    pipeline_depth : micro-batches a step splits into. None (the default)
                     = planner-resolved: per batch shape when serving, the
                     plan report's depth when training under plan="auto"
                     (else 1); an int pins it, clamped to a divisor of
                     the batch.
    exchange       : the row-wise wire mode, "partial_pool" or
                     "unpooled", of a row-wise config when the plan does
                     not dictate one (a placed plan's bulk group takes the
                     plan's own, as in the reference).
    optimizer      : sparse optimizer of training sessions ("sgd" |
                     "adagrad").
    lr             : learning rate of training sessions.
    seed           : parameter init + data stream seed.
    alpha          : Zipf skew of the synthetic stream (profiling AND data).
    device         : None (the CUDA device; raises without one) or an
                     explicit device such as "cpu".
    verbose        : print the plan summary when a plan is built.
    host_capacity_mb : device-memory budget (MiB) that turns the HOST
                     CHUNK TIER on: sessions serve and train through a
                     fresh ``hoststore.HostTieredExchange`` each -- full
                     weights in host memory, a hot slab + a device chunk
                     cache inside the budget, chunks swapping in ahead of
                     every step. Models BIGGER than the budget (and the
                     card) serve fine; that is the point. plan="none" and
                     SGD only; serving runs at depth 1 unless
                     ``pipeline_depth`` pins another.
    host_chunk_rows : rows per swap chunk (default: the perf model's pick).
    host_hot_fraction : budget share of the hot slab (default 0.5).
    host_link      : a ``perf_model.host_link(...)`` Interconnect pricing
                     the swaps (default: PCIe 4.0 x16, 16 GB/s).
    calibration    : path to (or dict of) a calibration artifact
                     (``core.calibration``) whose "host_link" entry
                     overrides the link's terms.
    metrics        : the MetricsRegistry the host tier's swap tallies go
                     to (None: the process-wide ``default_registry()``).
    mesh, axis, model_axis, dp_axes, compress_grads : the reference's
                     multi-device options (ROADMAP A6b). Only their
                     single-device defaults are accepted.
    """

    def __init__(self, cfg, *, plan: PlanArg = "none",
                 fast_mb: Optional[float] = None, profile_batches: int = 4,
                 fused_serve: str = "auto",
                 pipeline_depth: Optional[int] = None, seed: int = 0,
                 alpha: float = 0.0, device: DeviceArg = None,
                 exchange: str = "partial_pool", optimizer: str = "sgd",
                 lr: float = 0.01, verbose: bool = False,
                 mesh=None, axis=_AXIS, model_axis: int = 1,
                 dp_axes: Tuple[str, ...] = (),
                 compress_grads: bool = False, host_capacity_mb=None,
                 host_chunk_rows: Optional[int] = None,
                 host_hot_fraction: float = 0.5, host_link=None,
                 calibration=None, metrics=None):
        self.is_dlrm = isinstance(cfg, DLRMConfig)
        if isinstance(plan, str) and plan not in ("none", "auto"):
            raise ValueError(f"plan must be 'none', 'auto', or a "
                             f"ShardingPlan; got {plan!r}")
        if not self.is_dlrm:
            _check_lm(cfg, plan, pipeline_depth, compress_grads, dp_axes,
                      host_capacity_mb)
        if host_capacity_mb is not None:
            if host_capacity_mb <= 0:
                raise ValueError(f"host_capacity_mb must be > 0, got "
                                 f"{host_capacity_mb}")
            if plan not in (None, "none"):
                raise ValueError(
                    "host_capacity_mb composes the memory tiers itself "
                    "(hot slab + chunk cache + host store); it requires "
                    "plan='none'")
            if optimizer != "sgd":
                raise ValueError(
                    "host-tier training is SGD-only (AdaGrad accumulators "
                    "would need their own chunked host tier)")
        axis = (axis,) if isinstance(axis, str) else tuple(axis)
        if (mesh is not None or axis != _AXIS or model_axis != 1 or dp_axes
                or compress_grads):
            raise NotImplementedError(
                "a mesh or more than one device (mesh, axis, model_axis > "
                "1, dp_axes, compress_grads) is not ported yet (ROADMAP "
                "A6b, k ranks)")
        if exchange not in _ROW_WISE_EXCHANGES:
            raise ValueError(f"unknown row_wise exchange mode {exchange!r}")
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"optimizer must be 'sgd' or 'adagrad', got "
                             f"{optimizer!r}")
        if pipeline_depth is not None and pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        if fused_serve not in ("auto", "off"):
            raise ValueError(f"fused_serve must be 'auto' or 'off', got "
                             f"{fused_serve!r}")
        self.cfg = cfg
        self.fast_mb = fast_mb
        self.profile_batches = profile_batches
        self.fused_serve = fused_serve
        self.pipeline_depth = pipeline_depth
        self.seed = seed
        self.alpha = alpha
        self.optimizer = optimizer
        self.lr = lr
        self.exchange = exchange
        self.verbose = verbose
        self.device = resolve_device(device)
        self.host_capacity_mb = host_capacity_mb
        self.host_chunk_rows = host_chunk_rows
        self.host_hot_fraction = host_hot_fraction
        self.host_link = host_link
        self.calibration = calibration
        self.metrics = metrics
        self._plan_arg: PlanArg = plan
        self._reports: Dict[str, PlanReport] = {}

    # -- planning stage ----------------------------------------------------
    def build_plan(self, mode: str = "inference") -> Optional[ShardingPlan]:
        """Resolve the engine's ``plan=`` argument for a serving
        ("inference") or training mode. Auto plans are profiled once per
        mode (on the engine's device) and cached; concrete plans are
        reconciled against the one device."""
        if self._plan_arg in (None, "none"):
            return None
        if isinstance(self._plan_arg, ShardingPlan):
            return reconcile_plan_with_mesh(self._plan_arg, 1)
        if mode not in self._reports:
            report = build_auto_plan(
                self.cfg, 1, alpha=self.alpha, seed=self.seed,
                fast_mb=self.fast_mb, mode=mode,
                profile_batches=self.profile_batches, device=self.device)
            self._reports[mode] = report
            if self.verbose:
                print(report.summary())
        return self._reports[mode].plan

    def _row_mode(self, plan: Optional[ShardingPlan]) -> str:
        """The row-wise wire mode a session runs: the plan's, else the
        engine's ``exchange``."""
        return plan.exchange if plan is not None else self.exchange

    def _exchange_args(self, plan: Optional[ShardingPlan]) -> dict:
        """A session's exchange arguments, as the reference's
        ``_plan_and_exchange`` resolves them: the host tier first (a fresh
        one); else the session makes the plan's tiered exchange or the
        config's own layout, in the row-wise wire mode of the plan or the
        engine."""
        host = (self._host_exchange() if self.host_capacity_mb is not None
                else None)
        return dict(exchange=host, row_wise_exchange=self._row_mode(plan))

    def _host_exchange(self) -> HostTieredExchange:
        """A FRESH host-tier exchange (each session owns its own host
        weights, hot slab and chunk-cache state), sized for the engine's
        ``host_capacity_mb`` on its device."""
        link = self.host_link
        if link is None:
            link = perf_model.host_link(calibration=self.calibration)
        return build_host_exchange(
            self.cfg,
            device_capacity_bytes=int(self.host_capacity_mb * 2**20),
            alpha=self.alpha, seed=self.seed,
            chunk_rows=self.host_chunk_rows,
            hot_fraction=self.host_hot_fraction, link=link,
            profile_batches=max(1, self.profile_batches),
            metrics=self.metrics, device=self.device)

    def plan_report(self, mode: str = "inference") -> Optional[PlanReport]:
        """The cached profile/prediction report for an auto plan (None when
        plan="none", a concrete plan, or the mode hasn't been built yet)."""
        return self._reports.get(mode)

    def make_depth_resolver(self, mode: str) -> Callable[[int], int]:
        """Per-batch-shape depth resolver for serving: the executed-schedule
        sweep (``planning.resolve_depth_for_batch``) at the actual flushed
        sample count, under the engine's plan (its sharding mode, exchange,
        and measured hit ratio). ``ServeSession`` caches the result per
        shape."""
        plan = self.build_plan(mode)
        hit = plan.hit_ratio if plan is not None else 0.0
        placed = plan is not None and bool(plan.placements)
        sharding = plan.mode if placed else None
        exchange = self._row_mode(plan)
        pmode = "inference" if mode == "inference" else "training"

        def resolve(batch_samples: int) -> int:
            best, _ = resolve_depth_for_batch(
                self.cfg, 1, batch_samples, mode=pmode, sharding=sharding,
                exchange=exchange, hit_ratio=hit)
            return best

        return resolve

    def resolve_pipeline_depth(self, mode: str,
                               local_batch_samples: int) -> int:
        """The depth a session executes: the explicit engine setting, or
        the planner's choice (``PlanReport.pipeline_depth``) under an auto
        plan (else 1), clamped to the largest depth that splits the
        batch into whole micro-batches."""
        depth = self.pipeline_depth
        if depth is None:
            report = self._reports.get(mode)
            depth = report.pipeline_depth if report is not None else 1
        depth = min(int(depth), max(1, local_batch_samples))
        while depth > 1 and local_batch_samples % depth:
            depth -= 1
        return depth

    # -- sessions ----------------------------------------------------------
    def serve_session(self, *, max_batch_queries: int = 8,
                      max_wait_ms: float = 2.0, query_size=None,
                      params=None, warmup: bool = False) -> ServeSession:
        """Build the serving pipeline: plan -> serve step -> params ->
        dynamic micro-batcher. ``params`` serve given weights on the
        engine's device: stacked ``{"tables": ...}`` (split into the plan's
        table groups under a placed plan, else used without a copy) or
        plan-split ``{"tables_fast", "tables_bulk"}`` matching this plan's
        groups. The default is a fresh init from the engine seed on the
        device. Under the host tier the session serves a fresh host
        exchange's tables and takes only the MLPs of ``params``.
        ``warmup=True`` runs one untimed capacity batch first."""
        if not self.is_dlrm:
            raise ValueError("serve_session is DLRM-only")
        plan = self.build_plan("inference")
        exchange = self._exchange_args(plan)
        if self.host_capacity_mb is not None and self.pipeline_depth is None:
            # host tier without a pinned depth: depth 1 (synchronous
            # faulting); pin pipeline_depth to overlap the swaps
            depth, resolver = 1, None
        elif self.pipeline_depth is None:
            depth, resolver = None, self.make_depth_resolver("inference")
        else:
            # a pinned depth, clamped to a divisor of the capacity batch
            qs = int(query_size or self.cfg.batch_size)
            depth = self.resolve_pipeline_depth("inference",
                                                max_batch_queries * qs)
            resolver = None
        sess = ServeSession(
            self.cfg, device=self.device, plan=plan,
            max_batch_queries=max_batch_queries, max_wait_ms=max_wait_ms,
            query_size=query_size, params=params, seed=self.seed,
            alpha=self.alpha, warmup=warmup,
            pipeline_depth=depth, depth_resolver=resolver,
            fused=self.fused_serve != "off", **exchange)
        # record the kernel selection the session resolved on the cached
        # plan report, so plan_report("inference") tells the whole story
        rep = self._reports.get("inference")
        if rep is not None and rep.serve_kernel != sess.serve_kernel:
            self._reports["inference"] = dataclasses.replace(
                rep, serve_kernel=sess.serve_kernel)
        return sess

    def sharded_fleet(self, **kw):
        """Build a ``repro_torch.fabric.ShardedFleet`` from this engine's
        config on its device: N boards that TOGETHER own one partitioned
        table set (vs the replicated ``repro_torch.cluster`` fleet),
        profiled and partitioned with the engine's (alpha, seed) stream
        so the placement sees the traffic the fleet will serve. Every
        keyword (``n_boards``, ``board_capacity_bytes``, ``link``,
        ``cache_rows``, ``router``, ...) forwards to ``ShardedFleet``."""
        if not isinstance(self.cfg, DLRMConfig):
            raise ValueError("sharded_fleet is DLRM-only")
        from repro_torch.fabric import ShardedFleet
        return ShardedFleet(
            self.cfg, alpha=self.alpha, seed=self.seed,
            profile_batches=self.profile_batches, verbose=self.verbose,
            device=self.device, **kw)

    def train_session(self, *, ckpt_dir: Optional[str] = None,
                      ckpt_every: int = 50, ckpt_keep: int = 3,
                      batch: int = 8, seq: int = 128,
                      chain_prob: float = 0.8, schedule_steps: int = 100):
        """Build the training pipeline. A DLRM config: the plan for
        "training" (profiled in that mode under plan="auto") -> train step
        at the resolved depth -> params and optimizer state on the
        engine's device -> TrainLoop with checkpoint-resume, keeping
        ``ckpt_keep`` snapshots; its ``params`` serve through
        ``serve_session(params=...)`` of the same engine. An LM config:
        ``LMTrainSession`` (``batch``, ``seq``, ``chain_prob`` and
        ``schedule_steps`` apply; a DLRM session ignores them, as in the
        reference)."""
        if not self.is_dlrm:
            return LMTrainSession(
                self.cfg, device=self.device, lr=self.lr, seed=self.seed,
                batch=batch, seq=seq, chain_prob=chain_prob,
                schedule_steps=schedule_steps, ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, ckpt_keep=ckpt_keep)
        if ckpt_dir and self.host_capacity_mb is not None:
            raise NotImplementedError(HOST_TIER_CKPT)
        plan = self.build_plan("training")
        depth = self.resolve_pipeline_depth("training", self.cfg.batch_size)
        return TrainSession(
            self.cfg, device=self.device, plan=plan,
            optimizer=self.optimizer, lr=self.lr, seed=self.seed,
            alpha=self.alpha, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            ckpt_keep=ckpt_keep, pipeline_depth=depth,
            **self._exchange_args(plan))
