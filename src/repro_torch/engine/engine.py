"""Engine: one session API from config -> exchange -> step -> serve.

    from repro_torch.configs import get_dlrm
    from repro_torch.engine import Engine

    eng = Engine(get_dlrm("dlrm-rm2-small-unsharded"))    # on the card
    serve = eng.serve_session(max_batch_queries=4, max_wait_ms=2.0)
    report = serve.run_open_loop(n_queries=200, qps=400.0, sla_ms=50.0)

This slice of the port serves DLRM on one device with the config's own
table placement (``plan="none"``). Options of the reference's ``Engine``
that the slice does not carry raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import DLRMConfig
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.engine.serving import ServeSession


class Engine:
    """Session factory over one DLRM config on one device.

    Parameters
    ----------
    cfg            : DLRMConfig.
    plan           : "none" only (execute cfg.sharding as-is).
    fused_serve    : "auto" serves through the fused gather -> pool ->
                     interaction kernel whenever the exchange is local;
                     "off" forces the composed path. The choice is recorded
                     on ``ServeSession.serve_kernel``.
    pipeline_depth : micro-batches a serve step splits into (an int).
    seed           : parameter init + data stream seed.
    alpha          : Zipf skew of the synthetic query stream.
    device         : None (the CUDA device; raises without one) or an
                     explicit device such as "cpu".
    model_axis, dp_axes, host_capacity_mb : the reference's multi-device
                     and host-tier options; only their single-device
                     defaults are accepted.
    """

    def __init__(self, cfg, *, plan="none", fused_serve: str = "auto",
                 pipeline_depth: int = 1, seed: int = 0, alpha: float = 0.0,
                 device: DeviceArg = None, model_axis: int = 1,
                 dp_axes: Tuple[str, ...] = (), host_capacity_mb=None):
        if not isinstance(cfg, DLRMConfig):
            raise NotImplementedError(
                "LM configs are not ported yet (ROADMAP A8, LM substrate)")
        if plan not in (None, "none"):
            raise NotImplementedError(
                f"plan={plan!r} is not ported yet (ROADMAP A4, planner and "
                f"tiered serving); this slice takes plan='none'")
        if host_capacity_mb is not None:
            raise NotImplementedError(
                "host_capacity_mb (the host chunk tier) is not ported yet "
                "(ROADMAP A5, host tier)")
        if model_axis != 1 or dp_axes:
            raise NotImplementedError(
                "more than one device (model_axis > 1, dp_axes) is not "
                "ported yet (ROADMAP A6, distributed)")
        if pipeline_depth is None:
            raise NotImplementedError(
                "planner-resolved pipeline depth is not ported yet (ROADMAP "
                "A4, planner and tiered serving); pass an int")
        if fused_serve not in ("auto", "off"):
            raise ValueError(f"fused_serve must be 'auto' or 'off', got "
                             f"{fused_serve!r}")
        self.cfg = cfg
        self.fused_serve = fused_serve
        self.pipeline_depth = int(pipeline_depth)
        self.seed = seed
        self.alpha = alpha
        self.device = resolve_device(device)

    def serve_session(self, *, max_batch_queries: int = 8,
                      max_wait_ms: float = 2.0, query_size=None,
                      params=None, warmup: bool = False) -> ServeSession:
        """Build the serving pipeline: serve step -> params ->
        dynamic micro-batcher. ``params`` serve given weights (stacked
        ``{"tables": ...}`` on the engine's device, used without a copy);
        the default is a fresh init from the engine seed on the device.
        ``warmup=True`` runs one untimed capacity batch first."""
        return ServeSession(
            self.cfg, device=self.device,
            max_batch_queries=max_batch_queries, max_wait_ms=max_wait_ms,
            query_size=query_size, params=params, seed=self.seed,
            alpha=self.alpha, warmup=warmup,
            pipeline_depth=self.pipeline_depth,
            fused=self.fused_serve != "off")

    def train_session(self, **_):
        raise NotImplementedError(
            "training sessions are not ported yet (ROADMAP A3, training)")
