"""TrainSession: the engine's DLRM training path, on one rank or k.

Wraps ``runtime.TrainLoop`` (resume-from-latest, async checkpointing,
straggler accounting) around the plan-executing train step
(``parallel.build_step(mode="train")``) and its plan-aware optimizer
state, as the reference's ``repro.engine.training``; and, for the LM
workload, around the LM train step (``models.lm.make_train_step``) with
AdamW under a cosine schedule, on one rank or over k. Built by
``Engine.train_session()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import DLRMConfig, ModelConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.core.planner import ShardingPlan
from repro_torch.data.lm import make_lm_batch
from repro_torch.data.recsys import make_recsys_batch
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.models import lm
from repro_torch.models import transformer as T
from repro_torch.models.common import Sharder
from repro_torch.obs.serialize import report_asdict, report_to_json
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.convert import lm_param_specs
from repro_torch.parallel.build import (AXIS, build_step,
                                        init_dlrm_opt_state, init_local_dlrm,
                                        opt_state_specs, param_specs)
from repro_torch.parallel.exchange import EmbeddingExchange, make_exchange
from repro_torch.parallel.plan import (plan_table_groups,
                                       split_dlrm_params_in_place)
from repro_torch.runtime import TrainLoop


@dataclass(frozen=True)
class TrainReport:
    """Result of one ``TrainSession.run`` call."""

    workload: str              # "dlrm" | "lm"
    config: str
    start_step: int
    steps_run: int
    first_loss: float
    last_loss: float
    history: List[Dict[str, float]]

    def summary(self) -> str:
        return (f"[train] {self.workload} {self.config}: "
                f"steps={self.steps_run} (from {self.start_step}) "
                f"first_loss={self.first_loss:.4f} "
                f"last_loss={self.last_loss:.4f}")

    def asdict(self) -> dict:
        return report_asdict(self)

    def to_json(self, path: Optional[str] = None) -> str:
        return report_to_json(self, path)


class _SessionBase:
    """Shared resume/run plumbing over a ``TrainLoop``."""

    workload = "?"

    def __init__(self, cfg, loop: TrainLoop, init_state: Any):
        self.cfg = cfg
        self._loop = loop
        self._state, self.resume_step = loop.resume(init_state)
        self._next_step = self.resume_step

    @property
    def state(self) -> Any:
        return self._state

    @property
    def next_step(self) -> int:
        """The step (and batch) index the next ``run`` starts at."""
        return self._next_step

    def run(self, n_steps: int) -> TrainReport:
        start = self._next_step
        before = len(self._loop.history)
        self._state = self._loop.run(self._state, n_steps, start)
        self._next_step = start + n_steps
        hist = self._loop.history[before:]
        losses = [h["loss"] for h in hist]
        return TrainReport(
            workload=self.workload, config=self.cfg.name, start_step=start,
            steps_run=len(hist), first_loss=losses[0], last_loss=losses[-1],
            history=hist)


HOST_TIER_CKPT = (
    "checkpoints of a host-tier session are not ported yet (ROADMAP A5): "
    "the store's written-back rows and the chunk manager's residency, "
    "dirty and pos bookkeeping are not in them, so a resumed session "
    "would train on a fresh store")


def _manager(ckpt_dir: Optional[str], keep: int, mesh, specs,
             layout=None) -> Optional[CheckpointManager]:
    """The session's checkpoint manager (None without ``ckpt_dir``):
    over a mesh of more than one rank, collective by ``specs``."""
    if not ckpt_dir:
        return None
    return CheckpointManager(ckpt_dir, keep=keep, mesh=mesh, specs=specs,
                             layout=layout)


class TrainSession(_SessionBase):
    """DLRM training: the plan-executing step + TrainLoop, on one rank or
    on every rank of ``mesh``.

    The params are a fresh init from ``seed`` on ``device`` (None: the
    card), split in place into the plan's table groups (views of the one
    stacked tensor) under a placed ``plan``.
    Batch ``s`` is ``make_recsys_batch(cfg, s, seed, alpha)`` drawn on the
    device, so a resumed session sees the stream the uninterrupted one
    would. The step updates the tables in place; ``params`` and
    ``opt_state`` are the live tensors.

    ``exchange``: an ``EmbeddingExchange`` instance to train through (the
    ``Engine`` passes its host tier, SGD only); None makes the plan's
    tiered exchange or the config's own layout, a row-wise one in the wire
    mode ``row_wise_exchange`` names, through ``make_exchange``; the one
    trained through is kept as ``exchange_inst``. Its
    ``begin_batch(train=True)`` and ``end_batch`` bracket every
    step: the batch's cold chunks fault in (and are marked dirty) before
    the step. An exchange that holds the tables itself gets a fresh init
    of the MLPs only, and takes no ``ckpt_dir``.

    ``mesh`` (``launch.mesh.Mesh``; None: one device), ``axis``,
    ``dp_axes`` and ``compress_grads`` as ``build_step``'s: every rank
    builds the same session, draws only its shards of the init
    (``init_local_dlrm``) and runs the same loop over the same batches,
    training on its slice of each; ``params`` and ``opt_state`` are this
    rank's shards, and the loss is the global batch's. Its checkpoints
    hold the state at full width (``parallel.param_specs`` and
    ``opt_state_specs``), so one written on k ranks resumes on any number
    whose layout is the same: plan none without ``compress_grads``
    always; a placed plan only where its fast/bulk groups are the same
    (they are kept in the checkpoint's ``layout``), and the error-feedback
    residuals (one per rank) only at the same number of ranks. Any other
    resume raises ValueError (the reference would load such a state into
    the wrong shapes)."""

    workload = "dlrm"

    def __init__(self, cfg: DLRMConfig, *, device: DeviceArg = None,
                 plan: Optional[ShardingPlan] = None,
                 optimizer: str = "sgd", lr: float = 0.01, seed: int = 0,
                 alpha: float = 0.0, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, ckpt_keep: int = 3,
                 pipeline_depth: int = 1,
                 exchange: Optional[EmbeddingExchange] = None,
                 row_wise_exchange: str = "partial_pool",
                 mesh=None, axis=AXIS, dp_axes: Tuple[str, ...] = (),
                 compress_grads: bool = False):
        self.device = resolve_device(device)
        self.plan = plan
        self.pipeline_depth = int(pipeline_depth)
        n_embed = 1 if mesh is None else mesh.size(axis)
        exch = self.exchange_inst = (
            exchange if exchange is not None
            else make_exchange(cfg, n_embed, plan=plan,
                               row_wise_exchange=row_wise_exchange,
                               device=self.device,
                               group=None if mesh is None
                               else mesh.group(axis)))
        if ckpt_dir and exch.holds_tables:
            raise NotImplementedError(HOST_TIER_CKPT)
        step_fn = build_step(
            cfg, mesh, mode="train", axis=axis, dp_axes=dp_axes,
            exchange=exch, pipeline_depth=self.pipeline_depth,
            optimizer=optimizer, lr=lr, compress_grads=compress_grads)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = (dlrm_lib.init_mlps(cfg, gen) if exch.holds_tables
                  else init_local_dlrm(cfg, gen, exch))
        prepared = exch.init_session_params(params)
        if prepared is not None:
            params = prepared
        elif plan is not None and plan.placements and exch.n == 1:
            # the session owns this init: split it without a second copy
            params = split_dlrm_params_in_place(
                params, plan_table_groups(plan, 1))
        opt_state = init_dlrm_opt_state(cfg, optimizer, plan, n_embed,
                                        compress_grads, device=self.device)
        depth = self.pipeline_depth

        def loop_step(state, batch):
            p, o = state
            # the exchange faults this batch's cold chunks in (and marks
            # them dirty) before the step
            p, _ = exch.begin_batch(p, batch["indices"], depth, train=True)
            p, o, loss = step_fn(p, o, batch["dense"], batch["indices"],
                                 batch["labels"])
            return (exch.end_batch(p), o), {"loss": loss}

        device = self.device      # the loop must not hold the session

        groups = (plan_table_groups(plan, n_embed)
                  if plan is not None and plan.placements else None)
        specs = (param_specs(cfg, axis, groups),
                 opt_state_specs(cfg, optimizer, plan, n_embed,
                                 compress_grads, axis, dp_axes))
        layout = (None if groups is None else
                  {"fast_ids": list(groups.fast_ids),
                   "bulk_ids": list(groups.bulk_ids)})
        loop = TrainLoop(
            step_fn=loop_step,
            batch_fn=lambda s: make_recsys_batch(cfg, s, seed, alpha,
                                                 device=device),
            ckpt=_manager(ckpt_dir, ckpt_keep, mesh, specs, layout),
            ckpt_every=ckpt_every)
        super().__init__(cfg, loop, (params, opt_state))

    @property
    def params(self) -> Dict[str, Any]:
        return self._state[0]

    @property
    def opt_state(self) -> Any:
        return self._state[1]


class LMTrainSession(_SessionBase):
    """LM training: ``models.lm.make_train_step`` + TrainLoop, on one rank
    or on every rank of ``mesh``, as the reference's ``LMTrainSession``.

    The params are a fresh ``init_model`` from ``seed`` on ``device``
    (None: the card); AdamW at ``lr`` under ``cosine_schedule(10,
    schedule_steps)``; batch ``s`` is ``make_lm_batch(cfg, s, seed, batch,
    seq, chain_prob)`` drawn on the device, so a resumed session sees the
    stream the uninterrupted one would. The state is ``{"params", "opt",
    "step"}``, updated in place; checkpoints hold all of it.

    ``mesh`` (a ``launch.mesh.Mesh`` of more than one rank) trains under
    ``Sharder(mesh, moe_impl=moe_impl)``: every rank draws the same init
    and keeps its shards (``init_model(sharder=)``), draws the same
    batches and keeps its rows (``lm.shard_batch``; a batch that does not
    divide over the batch axes raises ValueError), and runs the same
    loop; the history's losses and grad norms are the global batch's.
    Checkpoints hold the state at full width (the expert weights and
    their AdamW moments gathered over "model", ``convert.lm_param_specs``)
    and resume on any mesh."""

    workload = "lm"

    def __init__(self, cfg: ModelConfig, *, device: DeviceArg = None,
                 lr: float = 3e-4, seed: int = 0, batch: int = 8,
                 seq: int = 128, chain_prob: float = 0.8,
                 schedule_steps: int = 100,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 ckpt_keep: int = 3, mesh=None, moe_impl: str = "auto"):
        multi = mesh is not None and mesh.size() > 1
        self.sharder = sharder = Sharder(mesh if multi else None,
                                         moe_impl=moe_impl)
        if batch % sharder.batch_size:
            raise ValueError(
                f"an LM batch of {batch} does not split over the "
                f"{sharder.batch_size} ranks of the batch axes "
                f"{sharder.batch_axes}")
        self.device = device = resolve_device(device)
        opt = adamw(lr, lr_schedule=cosine_schedule(10, schedule_steps))
        params = T.init_model(
            cfg, torch.Generator(device=device).manual_seed(seed), sharder)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
        p_specs = lm_param_specs(params, cfg, sharder)
        specs = {"params": p_specs,
                 "opt": {"mu": p_specs, "nu": p_specs, "count": None},
                 "step": None}
        loop = TrainLoop(
            step_fn=lm.make_train_step(cfg, opt, sharder),
            batch_fn=lambda s: lm.shard_batch(make_lm_batch(
                cfg, s, seed, batch, seq, chain_prob, device=device),
                sharder),
            ckpt=_manager(ckpt_dir, ckpt_keep, mesh if multi else None,
                          specs),
            ckpt_every=ckpt_every)
        super().__init__(cfg, loop, state)

    @property
    def params(self) -> Any:
        return self._state["params"]
