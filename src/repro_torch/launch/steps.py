"""Step builders of the dry-run's cells (the reference's
``src/repro/launch/steps.py``): a cell's program, rank 0's arguments on a
device, and the mesh they run on.

DLRM cells (the paper's own workload):
  {4 RM2 configs} x {train, serve}, the embedding axis per sharding mode:
    table_wise -> tables on the intra-pod ``model`` axis, replicated over
                  ("pod", "data"), the planner's choice for latency-bound
                  pooled exchanges;
    row_wise   -> rows sharded over EVERY rank (the paper's full
                  sharding).

The reference lowers each cell with abstract arguments
(``jax.ShapeDtypeStruct``) for 512 placeholder devices. The port runs it
(``CellProgram.run``) as one rank of a placeholder mesh
(``launch.mesh.make_production_mesh``): the step ``parallel.build_step``
builds (what the reference's ``core.sharding.make_dlrm_{serve,train}_step``
wrap), on rank 0's shards of the tables and rank 0's slice of the batch,
never the global tables. On the meta device nothing is allocated; on the
card the step runs for real.

LM cells (``build_lm_cell`` and its helpers) are ROADMAP A8c-ii: they
raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import build_step, make_exchange

SEED = 0

LM_NOT_PORTED = ("the LM half of the dry-run (its cells, the sharding "
                 "rules of models/sharding_rules.py and an executor driven "
                 "by them) is ROADMAP A8c-ii, not ported yet")


def _lm_half(name: str) -> Callable:
    def not_ported(*args, **kwargs):
        raise NotImplementedError(f"{name}: {LM_NOT_PORTED}")
    not_ported.__name__ = name
    return not_ported


input_specs = _lm_half("input_specs")
abstract_params = _lm_half("abstract_params")
abstract_caches = _lm_half("abstract_caches")
abstract_train_state = _lm_half("abstract_train_state")
train_state_shardings = _lm_half("train_state_shardings")
param_shardings = _lm_half("param_shardings")
batch_shardings = _lm_half("batch_shardings")
cache_shardings = _lm_half("cache_shardings")
build_lm_cell = _lm_half("build_lm_cell")
_make_remat_loss = _lm_half("_make_remat_loss")


@dataclasses.dataclass
class CellProgram:
    """One cell: ``fn``, the step of one rank, and ``make_args(device)``,
    rank 0's arguments built on a device (params, optimizer state, its
    slice of the global batch of ``global_batch`` samples)."""
    name: str
    fn: Callable
    make_args: Callable[[torch.device], Tuple]
    global_batch: int

    def run(self, device, args: Optional[Tuple] = None):
        """Run the step once on ``device`` (``args`` as ``make_args``
        builds them, or built here); returns (its output, the args)."""
        if args is None:
            args = self.make_args(torch.device(device))
        return self.fn(*args), args


# ---------------------------------------------------------------------------
# DLRM cell builders
# ---------------------------------------------------------------------------
def dlrm_queries_per_step(mesh: Mesh) -> int:
    """Queries batched a step: one per 16-rank group (the paper's system
    granularity), so the load a rank carries is the paper's a processor."""
    return max(1, mesh.size() // 16)


def dlrm_dryrun_config(cfg: DLRMConfig, mesh: Mesh) -> DLRMConfig:
    """An RM2 config fitted to the mesh: table_wise pads the table count
    to a multiple of the model axis (production padding); row_wise is
    unchanged."""
    if cfg.sharding == "table_wise":
        model = mesh.shape["model"]
        t_pad = ((cfg.num_tables + model - 1) // model) * model
        if t_pad != cfg.num_tables:
            cfg = dataclasses.replace(cfg, num_tables=t_pad,
                                      name=cfg.name + f"-pad{t_pad}")
    return cfg


def _filled(t: torch.Tensor, bound: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """``t`` drawn uniform in [-bound, bound] (left empty on meta)."""
    return t if gen is None else t.uniform_(-bound, bound, generator=gen)


def build_dlrm_cell(cfg: DLRMConfig, mode: str, mesh: Mesh,
                    row_wise_exchange: str = "unpooled",
                    rows_per_table: Optional[int] = None,
                    table_dtype: torch.dtype = torch.bfloat16
                    ) -> CellProgram:
    """mode: "train" | "serve"; the embedding axis per the module doc.

    ``table_dtype``: the tables are bf16 by default, as the reference's
    (the paper stores every parameter in fp16, Sec. V-A); the MLPs fp32.
    The step is ``build_step`` with the reference's arguments (SGD at lr
    0.01 for training), on this rank's slice of the batch and returning
    its own (``local_batch``: the reference's in and out shardings), with
    the dense agreement over ``dp_axes`` (``dp_sync="dense"``, the
    reference's ``tables + psum(new - tables)``). Weights and batch are
    drawn from ``SEED`` (values do not matter: the reference's cells have
    none)."""
    cfg = dlrm_dryrun_config(cfg, mesh)
    if rows_per_table is not None:
        cfg = dataclasses.replace(cfg, rows_per_table=rows_per_table)
    axes = mesh.axis_names
    if cfg.sharding == "table_wise":
        emb_axis = "model"
        dp_axes = tuple(a for a in axes if a != "model")
    else:
        emb_axis = tuple(axes)          # rows over every rank
        dp_axes = ()

    n_queries = dlrm_queries_per_step(mesh) * 16
    b_global = n_queries * cfg.batch_size
    n_all = mesh.size()
    # rounded to divide over every rank
    b_global = ((b_global + n_all - 1) // n_all) * n_all
    b_local = b_global // n_all

    exch = make_exchange(cfg, mesh.size(emb_axis),
                         row_wise_exchange=row_wise_exchange,
                         group=mesh.group(emb_axis))
    fn = build_step(cfg, mesh, mode=mode, axis=emb_axis, exchange=exch,
                    optimizer="sgd", lr=0.01, dp_axes=dp_axes,
                    local_batch=True, dp_sync="dense")

    def make_args(device: torch.device) -> Tuple:
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device)
            gen.manual_seed(SEED)
        params: Dict[str, object] = {
            k: [{n: _filled(torch.empty(s, device=device),
                            math.sqrt(1.0 / layer["w"][0]), gen)
                 for n, s in layer.items()} for layer in layers]
            for k, layers in dlrm_lib.mlp_shapes(cfg).items()}
        for k, (ids, _, rows) in exch.shards().items():
            params[k] = _filled(torch.empty(
                (len(ids), rows, cfg.embed_dim), dtype=table_dtype,
                device=device), math.sqrt(1.0 / cfg.rows_per_table), gen)
        shape = (b_local, cfg.num_tables, cfg.lookups_per_table)
        dense = torch.empty((b_local, cfg.num_dense), device=device)
        indices = torch.empty(shape, dtype=torch.int32, device=device)
        labels = torch.empty((b_local,), device=device)
        if gen is not None:
            dense.normal_(generator=gen)
            indices.random_(0, cfg.rows_per_table, generator=gen)
            labels.random_(0, 2, generator=gen)
        if mode == "serve":
            return params, dense, indices
        return params, None, dense, indices, labels

    return CellProgram(f"{cfg.name}/{mode}", fn, make_args, b_global)


def dlrm_lib_init(generator: torch.Generator, cfg: DLRMConfig):
    """The whole model on the generator's device (``core.dlrm.init_dlrm``),
    as the reference's ``dlrm_lib_init(key, cfg)``."""
    return dlrm_lib.init_dlrm(cfg, generator)
