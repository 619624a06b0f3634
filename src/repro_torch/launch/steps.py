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

LM cells (``build_lm_cell``):
  train_4k     -> train_step(state, batch)
  prefill_32k  -> prefill(params, batch)
  decode_32k   -> decode(params, caches, token, pos)    [+ memory for enc-dec]
  long_500k    -> decode with a 512k-deep cache (sub-quadratic archs only)

run as rank 0 of the placeholder mesh by the spec-driven executor
(``models.common.Sharder`` with the specs of ``models.sharding_rules``):
rank 0's shards of the params, optimizer state and caches, its rows of
the batch, the collectives the specs imply. The archs whose layers are
attention and dense MLP run; a MoE or SSM arch raises
``NotImplementedError`` naming ROADMAP A8c-ii-b.

The reference's abstract inputs (``jax.ShapeDtypeStruct``) are meta
tensors here, and its ``NamedSharding`` trees the filtered specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DLRMConfig, ModelConfig, ShapeConfig
from repro_torch.core import dlrm as dlrm_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as LM
from repro_torch.models import sharding_rules as rules
from repro_torch.models import transformer as T
from repro_torch.models.common import (COMPUTE_DTYPE, NULL_SHARDER, Sharder,
                                       init_std, tree_leaves)
from repro_torch.optim import adamw
from repro_torch.parallel import build_step, make_exchange, spmd
from repro_torch.parallel import primitives as P

SEED = 0

Params = Any


class _MetaGenerator(torch.Generator):
    """A generator whose device is meta: ``transformer.init_model`` draws
    nothing through it, and builds the tree of meta tensors."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors: shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The model-input stand-ins of one LM cell (global shapes)."""
    B = shape.global_batch
    if shape.kind in ("train", "prefill"):
        out, Ttxt = {}, shape.seq_len
        if cfg.frontend is not None and not cfg.is_encoder_decoder:
            Ttxt = shape.seq_len - cfg.n_frontend_tokens
            out["frontend_embeds"] = _meta((B, cfg.n_frontend_tokens,
                                            cfg.d_model))
        out["tokens"] = _meta((B, Ttxt), torch.int32)
        if shape.kind == "train":
            out["labels"] = _meta((B, Ttxt), torch.int32)
        if cfg.is_encoder_decoder:
            out["encoder_embeds"] = _meta((B, cfg.encoder_seq_len,
                                           cfg.d_model))
        return out
    # decode: one new token against a seq_len-deep cache
    return {"token": _meta((B,), torch.int32), "pos": _meta((), torch.int32)}


def abstract_params(cfg: ModelConfig) -> Params:
    return T.init_model(cfg, _MetaGenerator())


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int) -> Params:
    return T.init_cache(cfg, batch, max_len, device="meta")


def abstract_train_state(cfg: ModelConfig) -> Params:
    params = abstract_params(cfg)
    return {"params": params, "opt": adamw(1e-4).init(params),
            "step": _meta((), torch.int32)}


# ---------------------------------------------------------------------------
# Shardings: the filtered specs (``models.sharding_rules``)
# ---------------------------------------------------------------------------
def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def train_state_shardings(cfg: ModelConfig, mesh: Mesh) -> Params:
    """mu and nu mirror the params' specs; the counts are whole."""
    p_specs = param_shardings(cfg, mesh)
    return {"params": p_specs,
            "opt": {"mu": p_specs, "nu": p_specs, "count": rules.P()},
            "step": rules.P()}


def param_shardings(cfg: ModelConfig, mesh: Mesh) -> Params:
    return rules.named_shardings(cfg, abstract_params(cfg), mesh)


def batch_shardings(batch_abs: Params, mesh: Mesh) -> Params:
    return rules.batch_specs(batch_abs, mesh)


def cache_shardings(cfg: ModelConfig, caches_abs: Params,
                    mesh: Mesh) -> Params:
    return rules.cache_specs(cfg, caches_abs, mesh)


def memory_sharding(cfg: ModelConfig, batch: int, mesh: Mesh) -> rules.P:
    """whisper's cross-attention memory (U, B, S_enc, Hkv, hd): the batch
    over the data axes, S_enc over "model" where it divides."""
    shape = (cfg.n_layers, batch, cfg.encoder_seq_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return rules._fits(shape, rules.P(None, _batch_axes(mesh), "model",
                                      None, None), rules.mesh_shape(mesh))


def lm_sharder(cfg: ModelConfig, mesh: Mesh, batch: Optional[int] = None,
               max_len: Optional[int] = None) -> Sharder:
    """The spec-driven sharder of ``cfg`` on ``mesh`` (the reference's
    ``_sharder``): the batch over ("pod", "data"), the params' filtered
    specs, and with ``batch`` and ``max_len`` the caches' and the
    memory's."""
    cache_specs = memory_spec = None
    if max_len is not None:
        cache_specs = cache_shardings(cfg, abstract_caches(
            cfg, batch, max_len), mesh)
        if cfg.is_encoder_decoder:
            memory_spec = memory_sharding(cfg, batch, mesh)
    return Sharder(mesh, batch_axes=_batch_axes(mesh),
                   specs=param_shardings(cfg, mesh), cache_specs=cache_specs,
                   memory_spec=memory_spec)



@dataclasses.dataclass
class CellProgram:
    """One cell: ``fn``, the step of one rank, and ``make_args(device)``,
    rank 0's arguments built on a device (params, optimizer state, its
    slice of the global batch of ``global_batch`` samples).
    ``timed_untraced``: the dry-run times the step in a second, untraced
    run (a DLRM step of milliseconds, which the trace's per-op cost
    would swamp); an LM cell's step is timed in its traced run, one run
    a cell (PERF.md gives the gap at a cell of seconds)."""
    name: str
    fn: Callable
    make_args: Callable[[torch.device], Tuple]
    global_batch: int
    timed_untraced: bool = True

    def run(self, device, args: Optional[Tuple] = None):
        """Run the step once on ``device`` (``args`` as ``make_args``
        builds them, or built here); returns (its output, the args)."""
        if args is None:
            args = self.make_args(torch.device(device))
        return self.fn(*args), args


# ---------------------------------------------------------------------------
# LM cell builders
# ---------------------------------------------------------------------------
def draw_params(cfg: ModelConfig, sharder: Sharder, device: torch.device,
                gen: Optional[torch.Generator]) -> Params:
    """This rank's shard of every param, drawn as the init draws it
    (left empty on meta); a rank never holds a whole leaf."""
    def draw(path, leaf):
        spec = rules.spec_of(sharder.specs, path)
        t = torch.empty(spmd.local_shape(tuple(leaf.shape), spec,
                                         sharder.mesh), device=device)
        std = init_std(path.rsplit("/", 1)[-1], leaf.shape, cfg.n_layers)
        if gen is None:
            return t
        if std is None:
            return t.fill_(1.0)
        return t.normal_(0.0, std, generator=gen) if std else t.zero_()
    return rules.tree_map_with_path(draw, abstract_params(cfg))


def _local_batch(batch_abs: Params, mesh: Mesh, device: torch.device,
                 gen: Optional[torch.Generator], vocab: int) -> Params:
    """This rank's rows of the batch: ids uniform over the vocabulary,
    embeddings N(0, 0.02^2)."""
    specs = batch_shardings(batch_abs, mesh)

    def local(path, leaf):
        shape = spmd.local_shape(tuple(leaf.shape), rules.spec_of(
            specs, path), mesh)
        t = torch.empty(shape, dtype=leaf.dtype, device=device)
        if gen is None:
            return t
        if leaf.dtype == torch.int32:
            return t.random_(0, vocab, generator=gen)
        return t.normal_(0.0, 0.02, generator=gen)
    return rules.tree_map_with_path(local, batch_abs)


def _slot_positions(S: int, s0: int, S_full: int, pos: int,
                    device) -> torch.Tensor:
    """The position each slot [s0, s0 + S) of a (ring) cache of S_full
    slots holds after ``pos`` tokens: the latest p < pos with
    p % S_full == slot, else -1 (empty)."""
    slot = torch.arange(s0, s0 + S, device=device)
    p = slot + S_full * torch.div(pos - 1 - slot, S_full,
                                  rounding_mode="floor")
    return torch.where(slot <= pos - 1, p,
                       torch.full_like(p, -1)).to(torch.int32)


def _local_caches(cfg: ModelConfig, sharder: Sharder, batch: int,
                  max_len: int, pos: int, device: torch.device,
                  gen: Optional[torch.Generator]) -> Params:
    """This rank's cache blocks after ``pos`` tokens: k and v drawn
    N(0, 1) in the compute dtype, each slot's position as the decode
    path wrote it."""
    caches_abs = abstract_caches(cfg, batch, max_len)
    S_full = max_len if cfg.sliding_window is None else min(
        max_len, cfg.sliding_window)

    def local(path, leaf):
        spec = rules.spec_of(sharder.cache_specs, path)
        shape = spmd.local_shape(tuple(leaf.shape), spec, sharder.mesh)
        t = torch.empty(shape, dtype=leaf.dtype, device=device)
        if gen is None:
            return t
        if path.endswith("pos"):
            split = spec[2] == "model"
            s0 = sharder.model_rank * shape[-1] if split else 0
            return t.copy_(_slot_positions(shape[-1], s0, S_full, pos,
                                           device).expand(shape))
        return t.normal_(0.0, 1.0, generator=gen)
    return rules.tree_map_with_path(local, caches_abs)


def _make_remat_loss(cfg: ModelConfig, sharder: Sharder, remat: bool):
    """loss_fn(params, batch): ``forward(remat=)`` and the chunked
    cross-entropy. Over a spec-driven sharder: this rank's summed NLL of
    its rows over the global count of valid labels (psummed over the
    batch axes), so that the ranks' losses and grads sum to the global
    batch's."""
    def loss_fn(params, batch):
        hidden = T.forward(
            params, cfg, batch["tokens"], sharder=sharder, remat=remat,
            frontend_embeds=batch.get("frontend_embeds"),
            encoder_embeds=batch.get("encoder_embeds"))
        fe = (cfg.n_frontend_tokens
              if (cfg.frontend and not cfg.is_encoder_decoder) else 0)
        if not sharder.spmd:
            return LM.chunked_cross_entropy(params, cfg, hidden[:, fe:, :],
                                            batch["labels"])
        loss_sum, count = LM.cross_entropy_sums_spmd(
            params, cfg, hidden[:, fe:, :], batch["labels"], sharder)
        count = P.psum(count, sharder.group(sharder.batch_axes))
        return loss_sum / count.clamp_min(1).float()
    return loss_fn


def make_lm_train_step(cfg: ModelConfig, sharder: Sharder = NULL_SHARDER,
                       remat: bool = True):
    """The train cell's step(state, batch) -> (state, {"loss"}): the
    remat loss's grads (over a spec-driven sharder summed as
    ``Sharder.sync_grads`` says, the loss psummed over the batch axes),
    then the reference's AdamW at 1e-4, params and optimizer state
    updated in place. Returns (step, the optimizer)."""
    opt = adamw(1e-4)
    loss_fn = _make_remat_loss(cfg, sharder, remat)

    def train_step(state, batch):
        params = state["params"]
        loss, grads = LM.value_and_grad(loss_fn, params, batch)
        if sharder.spmd:
            grads = sharder.sync_grads(grads, sharder.specs)
            loss = P.psum(loss, sharder.group(sharder.batch_axes))
        updates, new_opt = opt.update(grads, state["opt"], params)
        del grads
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u)
        return ({"params": params, "opt": new_opt,
                 "step": state["step"] + 1}, {"loss": loss})
    return train_step, opt


def build_lm_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                  remat: bool = True) -> CellProgram:
    """One LM cell as rank 0 of ``mesh`` (see the module doc); its
    ``make_args(device)`` draws rank 0's shards and rows from ``SEED``."""
    T._check_spmd(cfg)
    name = f"{cfg.name}/{shape.name}"
    B = shape.global_batch
    batch_abs = input_specs(cfg, shape)

    def generator(device):
        if device.type == "meta":
            return None
        return torch.Generator(device=device).manual_seed(SEED)

    if shape.kind == "train":
        sharder = lm_sharder(cfg, mesh)
        step, opt = make_lm_train_step(cfg, sharder, remat)

        def make_args(device):
            gen = generator(device)
            params = draw_params(cfg, sharder, device, gen)
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            return state, _local_batch(batch_abs, mesh, device, gen,
                                       cfg.vocab_size)
        return CellProgram(name, step, make_args, B,
                           timed_untraced=False)

    max_len = shape.seq_len
    sharder = lm_sharder(cfg, mesh, B, max_len)
    if shape.kind == "prefill":
        def make_args(device):
            gen = generator(device)
            return (draw_params(cfg, sharder, device, gen),
                    _local_batch(batch_abs, mesh, device, gen,
                                 cfg.vocab_size))
        return CellProgram(name, LM.make_prefill_step(cfg, max_len, sharder),
                           make_args, B, timed_untraced=False)

    # decode: the new token at position seq_len - 1 of the cache
    decode = LM.make_decode_step(cfg, sharder)
    pos = max_len - 1

    def make_args(device):
        gen = generator(device)
        params = draw_params(cfg, sharder, device, gen)
        caches = _local_caches(cfg, sharder, B, max_len, pos, device, gen)
        token = _local_batch({"token": batch_abs["token"]}, mesh, device,
                             gen, cfg.vocab_size)["token"]
        args = [params, caches, token, pos]
        if cfg.is_encoder_decoder:
            shape_m = spmd.local_shape(
                (cfg.n_layers, B, cfg.encoder_seq_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim), sharder.memory_spec, mesh)
            mem = tuple(torch.empty(shape_m, dtype=COMPUTE_DTYPE,
                                    device=device) for _ in range(2))
            if gen is not None:
                for m in mem:
                    m.normal_(0.0, 1.0, generator=gen)
            args.append(mem)
        return tuple(args)
    return CellProgram(name, decode, make_args, B, timed_untraced=False)


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
