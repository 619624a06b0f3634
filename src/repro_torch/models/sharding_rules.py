"""Partition specs of LM parameters, optimizer state, KV caches and batches
(the reference's ``src/repro/models/sharding_rules.py``).

Strategy: weights are 2D-sharded. ``data`` is the FSDP/ZeRO-3 axis,
``model`` the tensor-parallel axis. The ``pod`` axis is pure data
parallelism (params replicated across pods; only the grads' reduction
crosses it), the paper's scale-in principle: latency-bound collectives
(TP all-reduces, embedding all-to-alls) stay inside a pod.

A spec (``P``) is a tuple with one entry a dim: an axis name, a tuple of
axis names (their flattened group) or None (whole along that dim); a
spec shorter than its tensor is whole along the dims it leaves out. The
port has no ``NamedSharding``: a spec and the mesh it was filtered for
are the placement, and ``parallel.spmd`` cuts a rank's shard by them.

Rules are matched on the parameter's key path ("units/0/attn/wq", dict
keys and list indices joined by "/", as the reference's ``_path_str``
joins a pytree's), so they survive stacking: a stacked layer param has a
leading (n_units,) dim, and the rules index from the trailing dims.

Divisibility policy: a spec axis is applied only if the dim divides the
mesh axis size; otherwise that dim falls back to whole (e.g. GQA
kv_heads=8 < model=16: wk/wv's Hkv*hd = 1,024 columns still divide 16,
so they are split mid-head; ``_fits`` checks only divisibility).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ModelConfig

Params = Any

DATA = "data"
MODEL = "model"


class P(tuple):
    """A partition spec: ``P("data", None)``; ``P()`` is whole. A tuple
    of one axis is that axis, as ``jax.sharding.PartitionSpec`` keeps
    it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _fits(shape: Tuple[int, ...], spec: P,
          mesh_shape: Mapping[str, int]) -> P:
    """Zero out spec entries that don't divide; drop entries beyond ndim.

    The reference notes (its §Perf iteration 8, refuted) that a minimum
    shard width which replicates over-sharded tiny dims (whisper-base's
    d = 512 in 32-wide TP shards) cut the collective term 35x but grew the
    memory term 9x; the fix would be a smaller ``model`` degree, which the
    fixed production mesh of the dry-run does not allow."""
    out = []
    for dim, axes in enumerate(spec):
        if dim >= len(shape) or axes is None:
            out.append(None)
            continue
        size = 1
        for a in _axes(axes):
            size *= mesh_shape.get(a, 1)
        out.append(axes if (size > 1 and shape[dim] % size == 0) else None)
    while len(out) < len(shape):
        out.append(None)
    return P(*out)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Params,
                       path: Tuple = ()) -> Params:
    """``fn(path, leaf)`` on every leaf of a tree of dicts, lists and
    tuples (a ``P`` is a leaf), ``path`` as ``_path_str`` joins it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(_path_str(path), tree)


def _path_str(path) -> str:
    """A key path (dict keys and list indices) joined by "/", as the
    reference joins a pytree's."""
    return "/".join(str(p) for p in path)


def _rule(path: str, shape: Tuple[int, ...], cfg: ModelConfig,
          fsdp: bool = True) -> P:
    """Spec BEFORE divisibility filtering. Stacked layer params have a
    leading (n_units,) dim: rules index from the trailing dims."""
    nd = len(shape)
    d_ax = DATA if fsdp else None

    def trail(*axes):
        """A spec that right-aligns ``axes`` against the shape (the
        stacked leading dim is left whole)."""
        return P(*([None] * (nd - len(axes)) + list(axes)))

    name = path.rsplit("/", 1)[-1]

    # --- embeddings / head -------------------------------------------------
    if name == "embed":                      # (V, d): vocab over model
        return P(MODEL, d_ax)
    if name == "lm_head":                    # (d, V)
        return P(d_ax, MODEL)
    if name == "frontend_proj":
        return P(d_ax, MODEL)

    # --- attention ----------------------------------------------------------
    if name == "wq":                         # (d, Hq*hd): column parallel
        return trail(d_ax, MODEL)
    if name in ("wk", "wv"):                 # (d, Hkv*hd): the divisibility
        return trail(d_ax, MODEL)            # filter decides
    if name == "wo":                         # (Hq*hd, d): row parallel
        return trail(MODEL, d_ax)
    if name in ("bq", "bk", "bv"):
        return trail(MODEL)

    # --- dense MLP / MoE ----------------------------------------------------
    if name in ("w_gate", "w_up"):
        if "moe" in path:                    # (E, d, ff)
            if cfg.moe and cfg.moe.num_experts % 16 == 0:
                return trail(MODEL, d_ax, None)      # expert parallel
            return trail(None, d_ax, MODEL)          # d_ff tensor parallel
        return trail(d_ax, MODEL)            # (d, ff) column parallel
    if name == "w_down":
        if "moe" in path:                    # (E, ff, d)
            if cfg.moe and cfg.moe.num_experts % 16 == 0:
                return trail(MODEL, None, d_ax)
            return trail(None, MODEL, d_ax)
        return trail(MODEL, d_ax)            # (ff, d) row parallel
    if name == "router":                     # (d, E)
        return trail(d_ax, None)

    # --- mamba ---------------------------------------------------------------
    if name == "w_in":                       # (d, 2*di)
        return trail(d_ax, MODEL)
    if name == "conv_w":                     # (dc, di)
        return trail(None, MODEL)
    if name in ("conv_b", "dt_bias", "d_skip"):  # (di,)
        return trail(MODEL)
    if name == "w_x":                        # (di, dt_rank+2ds)
        return trail(MODEL, None)
    if name == "w_dt":                       # (dt_rank, di)
        return trail(None, MODEL)
    if name == "a_log":                      # (di, ds)
        return trail(MODEL, None)
    if name == "w_out":                      # (di, d)
        return trail(MODEL, d_ax)

    # --- rwkv6 ---------------------------------------------------------------
    if name in ("w_r", "w_k", "w_v", "w_g"):  # (d, d) / cmix (d, ff)
        return trail(d_ax, MODEL)
    if name == "w_o":                         # (d, d)
        return trail(MODEL, d_ax)
    if name == "w_decay_a":                   # (d, lora)
        return trail(d_ax, None)
    if name == "w_decay_b":                   # (lora, d)
        return trail(None, MODEL)

    # norms, mixes, bonus, scalars: whole
    return P()


def param_specs(cfg: ModelConfig, params: Params, fsdp: bool = True
                ) -> Params:
    """A tree of ``P`` congruent with ``params`` (tensors of any device,
    meta ones included), before divisibility filtering."""
    return tree_map_with_path(
        lambda path, leaf: _rule(path, tuple(leaf.shape), cfg, fsdp), params)


def mesh_shape(mesh) -> Dict[str, int]:
    """A ``launch.mesh.Mesh``'s (or a plain mapping's) sizes by axis."""
    return dict(getattr(mesh, "shape", mesh))


def filter_specs(specs: Params, params: Params, mesh) -> Params:
    """Divisibility filtering for a concrete mesh."""
    shape = mesh_shape(mesh)
    out = tree_map_with_path(lambda path, s: s, specs)   # a copy
    leaves = {}
    tree_map_with_path(lambda path, leaf: leaves.__setitem__(path, leaf),
                       params)
    return tree_map_with_path(
        lambda path, s: _fits(tuple(leaves[path].shape), s, shape), out)


def named_shardings(cfg: ModelConfig, params: Params, mesh,
                    fsdp: bool = True) -> Params:
    """The filtered specs: with ``mesh``, the port's counterpart of the
    reference's ``NamedSharding`` tree."""
    return filter_specs(param_specs(cfg, params, fsdp), params, mesh)


# ---------------------------------------------------------------------------
# KV-cache / decode-state specs
# ---------------------------------------------------------------------------
def _batch_axes(shape: Mapping[str, int],
                batch_axes: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(a for a in batch_axes if a in shape)


def cache_specs(cfg: ModelConfig, caches: Params, mesh,
                batch_axes: Tuple[str, ...] = ("pod", "data")) -> Params:
    """Decode state: the batch dim over the data axes; the KV sequence dim
    over ``model`` (keeps a 32k x Hkv x hd cache within a rank's memory
    even when kv_heads < |model|); SSM states: the feature dim over
    model."""
    shape = mesh_shape(mesh)
    b_axes = _batch_axes(shape, batch_axes)

    def spec(path, leaf):
        name = path.rsplit("/", 1)[-1]
        nd = len(leaf.shape)
        if name in ("k", "v"):          # (U, B, S, Hkv, hd)
            return _fits(leaf.shape, P(None, b_axes, MODEL, None, None),
                         shape)
        if name == "pos":               # (U, B, S)
            return _fits(leaf.shape, P(None, b_axes, MODEL), shape)
        if name == "conv":              # (U, B, dc-1, di)
            return _fits(leaf.shape, P(None, b_axes, None, MODEL), shape)
        if name == "ssm":               # (U, B, di, ds)
            return _fits(leaf.shape, P(None, b_axes, MODEL, None), shape)
        if name == "wkv":               # (U, B, H, hd, hd)
            return _fits(leaf.shape, P(None, b_axes, MODEL, None, None),
                         shape)
        if name in ("x_prev", "cmix_prev"):   # (U, B, d)
            return _fits(leaf.shape, P(None, b_axes, MODEL), shape)
        return _fits(leaf.shape, P(*([None] * nd)), shape)

    return tree_map_with_path(spec, caches)


def batch_specs(batch: Params, mesh,
                batch_axes: Tuple[str, ...] = ("pod", "data")) -> Params:
    """Every batch leaf split along its leading dim over the data axes."""
    shape = mesh_shape(mesh)
    b_axes = _batch_axes(shape, batch_axes)
    return tree_map_with_path(
        lambda path, leaf: _fits(tuple(leaf.shape), P(
            b_axes, *([None] * (len(leaf.shape) - 1))), shape), batch)


def spec_of(specs: Params, path: str) -> Optional[P]:
    """The spec at ``path`` ("units/0/attn/wq") of a spec tree."""
    node = specs
    for key in path.split("/"):
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node
