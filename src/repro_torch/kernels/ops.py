"""Public kernel entry points, dispatched by the tensors' device.

A CUDA tensor launches the hand-written kernel, and a failed build or
launch raises. A CPU tensor runs the plain version in ``kernels.ref``. A
meta tensor (the dry-run's trace without allocation) returns an empty
meta tensor of the kernel's output shape and dtype. Nothing else selects
the path: there is no environment switch and no fallback from the kernel
to the plain version.

``launch_counts`` counts, per kernel, the launches made through these
entry points, so a run can show that its main path went through the
kernel. Direct calls of a kernel's wrapper (as when it is held against
its plain version) are not counted.

Under an op stream (``repro_torch.op_stream.OpStream``, the dry-run's
counts) each call reports itself as one op, whatever its device: its
operands, its result and its flops, counted as the reference counts the
dot it replaces (the bags none). The plain version and the meta branch
run untraced, so the card, the CPU and the meta device count one stream.
The meta output's shape and the flops are worked out only when needed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import attention
from repro_torch.kernels import embedding_bags as bag_kernels
from repro_torch.kernels import feature_interactions, fused_serve, ref
from repro_torch.op_stream import active

launch_counts: Dict[str, int] = {
    "fused_bag_interactions": 0,
    "fused_cached_bag_interactions": 0,
    "fused_grouped_bag_interactions": 0,
    "embedding_bag": 0,
    "cached_embedding_bag": 0,
    "embedding_bag_blocked": 0,
    "interactions": 0,
    "flash_attention": 0,
    "flash_decode": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _launch(name: str, at: torch.Tensor, inputs, cuda: Callable,
            cpu: Callable, meta: Callable,
            flops: Optional[Callable[[], float]] = None,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Run ``name`` on ``at``'s device (``cuda``: the kernel, counted in
    ``launch_counts``; ``cpu``: the plain version; ``meta``: the output's
    shape), reported to the op stream in force as one op of ``inputs``
    and ``flops()`` in ``dtype``."""
    kind = at.device.type
    stream = active()
    if kind == "cuda" and stream is None:
        out = cuda()
        launch_counts[name] += 1
        return out
    if kind == "cuda":
        fn = cuda
    elif kind == "cpu":
        fn = cpu
    elif kind == "meta":
        fn = meta
    else:
        raise ValueError(f"{name}: no path for tables on {at.device}")
    if stream is None:
        out = fn()
    else:
        with stream.untraced():
            out = fn()
        stream.kernel(name, inputs, out, flops() if flops else 0.0, dtype)
    if kind == "cuda":
        launch_counts[name] += 1
    return out


def _contiguous(out):
    """A plain version's output laid out as the kernel writes it (rows
    in order), so that the ops after it run alike on the CPU and the
    card."""
    if isinstance(out, tuple):
        return tuple(t.contiguous() for t in out)
    return out.contiguous()


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _pooled_shape(indices: torch.Tensor, d: int):
    return (indices.shape[0], indices.shape[1], d)


def _interaction_flops(B: int, T: int, d: int) -> float:
    """The dot of ``einsum("bid,bjd->bij", A, A)``, A (B, T+1, d)."""
    return 2.0 * B * (T + 1) * (T + 1) * d


def _features_shape(bot_out: torch.Tensor, T: int):
    return (bot_out.shape[0], bot_out.shape[1] + (T + 1) * T // 2)


def embedding_bag(tables: torch.Tensor,
                  indices: torch.Tensor) -> torch.Tensor:
    """(T, R, d) x (B, T, L) -> (B, T, d) pooled, fp32; one launch on the
    card."""
    return _launch(
        "embedding_bag", tables, (tables, indices),
        lambda: bag_kernels.embedding_bag(tables, indices),
        lambda: ref.embedding_bag_ref(tables, indices),
        lambda: _meta(_pooled_shape(indices, tables.shape[-1])))


def embedding_bag_blocked(tables: torch.Tensor, indices: torch.Tensor, *,
                          lblk: int = 8) -> torch.Tensor:
    """(T, R, d) x (B, T, L) -> (B, T, d) pooled, fp32, read ``lblk``
    consecutive rows at a time when the stream is aligned; one launch on
    the card. L % lblk != 0 raises ValueError."""
    def meta():
        bag_kernels.check_lblk("embedding_bag_blocked", indices.shape[-1],
                               lblk)
        return _meta(_pooled_shape(indices, tables.shape[-1]))

    return _launch(
        "embedding_bag_blocked", tables, (tables, indices),
        lambda: bag_kernels.embedding_bag_blocked(tables, indices,
                                                  lblk=lblk),
        lambda: ref.embedding_bag_blocked_ref(tables, indices, lblk), meta)


def cached_embedding_bag(fast: torch.Tensor, bulk: torch.Tensor,
                         fast_idx: torch.Tensor,
                         bulk_idx: torch.Tensor) -> torch.Tensor:
    """Two-tier cached bag: (T, S+1, d) x (T, R+1, d) x 2 x (B, T, L)
    pre-translated slots -> (B, T, d) pooled, fp32; one launch on the
    card. A 2-D bulk (R+1, d) is one tier that every table reads, as the
    (T, R+1, d) tier ``bulk[None].expand(T, -1, -1)``. Shapes that
    disagree raise ValueError."""
    def plain():
        bag_kernels.cached_shapes("cached_embedding_bag", fast, bulk,
                                  fast_idx, bulk_idx)
        b = bulk[None].expand(fast.shape[0], -1, -1) if bulk.dim() == 2 \
            else bulk
        return ref.cached_embedding_bag_ref(fast, b, fast_idx, bulk_idx)

    def meta():
        bag_kernels.cached_shapes("cached_embedding_bag", fast, bulk,
                                  fast_idx, bulk_idx)
        return _meta(_pooled_shape(fast_idx, fast.shape[-1]))

    return _launch(
        "cached_embedding_bag", fast, (fast, bulk, fast_idx, bulk_idx),
        lambda: bag_kernels.cached_embedding_bag(fast, bulk, fast_idx,
                                                 bulk_idx), plain, meta)


def interactions(bot_out: torch.Tensor,
                 pooled: torch.Tensor) -> torch.Tensor:
    """(B, d) x (B, T, d) -> (B, d + (T+1)T/2) fp32; one launch on the
    card."""
    B, T, d = pooled.shape
    return _launch(
        "interactions", pooled, (bot_out, pooled),
        lambda: feature_interactions.interactions(bot_out, pooled),
        lambda: ref.interactions_ref(bot_out, pooled),
        lambda: _meta(_features_shape(bot_out, T)),
        lambda: _interaction_flops(B, T, d))


def fused_bag_interactions(tables: torch.Tensor, indices: torch.Tensor,
                           bot_out: torch.Tensor) -> torch.Tensor:
    """(T, R, d) x (B, T, L) x (B, d) -> (B, d + (T+1)T/2) fp32 fused
    gather -> pool -> interaction features; one launch on the card."""
    B, T, _ = indices.shape
    return _launch(
        "fused_bag_interactions", tables, (tables, indices, bot_out),
        lambda: fused_serve.fused_bag_interactions(tables, indices, bot_out),
        lambda: ref.fused_bag_interactions_ref(tables, indices, bot_out),
        lambda: _meta(_features_shape(bot_out, T)),
        lambda: _interaction_flops(B, T, bot_out.shape[1]))


def fused_cached_bag_interactions(fast: torch.Tensor, bulk: torch.Tensor,
                                  fast_idx: torch.Tensor,
                                  bulk_idx: torch.Tensor,
                                  bot_out: torch.Tensor) -> torch.Tensor:
    """Two-tier fused serve path: (T, S+1, d) x (T, R+1, d) x 2 x (B, T, L)
    x (B, d) -> (B, d + (T+1)T/2) fp32 interaction features; one launch on
    the card."""
    B, T, _ = fast_idx.shape
    return _launch(
        "fused_cached_bag_interactions", fast,
        (fast, bulk, fast_idx, bulk_idx, bot_out),
        lambda: fused_serve.fused_cached_bag_interactions(
            fast, bulk, fast_idx, bulk_idx, bot_out),
        lambda: ref.fused_cached_bag_interactions_ref(
            fast, bulk, fast_idx, bulk_idx, bot_out),
        lambda: _meta(_features_shape(bot_out, T)),
        lambda: _interaction_flops(B, T, bot_out.shape[1]))


def fused_grouped_bag_interactions(tables_fast: torch.Tensor,
                                   tables_bulk: torch.Tensor,
                                   indices_perm: torch.Tensor,
                                   bot_out: torch.Tensor, *, inv_perm,
                                   pos: torch.Tensor) -> torch.Tensor:
    """Tiered-plan fused serve path: (Tf, Rf, d) + (Tb, Rb, d) table groups,
    indices (B, Tf+Tb, L) pre-permuted to concat(fast, bulk) order, output
    (B, d + (T+1)T/2) in the original table order; one launch on the card.

    ``inv_perm`` is the plan's ``PlanGroups.inv_perm`` and ``pos`` its
    ``fused_serve.grouped_pos(inv_perm, device)``, built once by the
    caller (the tiered exchange); the card reads ``pos``, the plain
    version ``inv_perm``."""
    B, T, _ = indices_perm.shape
    return _launch(
        "fused_grouped_bag_interactions", bot_out,
        (tables_fast, tables_bulk, indices_perm, bot_out, pos),
        lambda: fused_serve.fused_grouped_bag_interactions(
            tables_fast, tables_bulk, indices_perm, bot_out, pos),
        lambda: ref.fused_grouped_bag_interactions_ref(
            tables_fast, tables_bulk, indices_perm, bot_out, inv_perm),
        lambda: _meta(_features_shape(bot_out, T)),
        lambda: _interaction_flops(B, T, bot_out.shape[1]))


def fused_grouped_bag_interactions_unpermuted(
        tables_fast: torch.Tensor, tables_bulk: torch.Tensor,
        indices: torch.Tensor, bot_out: torch.Tensor, *, inv_perm,
        src: torch.Tensor) -> torch.Tensor:
    """``fused_grouped_bag_interactions`` on indices (B, Tf+Tb, L) in the
    ORIGINAL table order: the kernel walks the tables in that order, so
    the ids are never permuted; counted as a launch of
    ``fused_grouped_bag_interactions``, the same kernel.

    ``src`` is ``fused_serve.grouped_src(inv_perm, device)``, built once by
    the caller (the tiered exchange); the card reads ``src``, the plain
    version ``inv_perm``."""
    B, T, _ = indices.shape
    return _launch(
        "fused_grouped_bag_interactions", bot_out,
        (tables_fast, tables_bulk, indices, bot_out, src),
        lambda: fused_serve.fused_grouped_bag_interactions_unpermuted(
            tables_fast, tables_bulk, indices, bot_out, src),
        lambda: ref.fused_grouped_bag_interactions_unpermuted_ref(
            tables_fast, tables_bulk, indices, bot_out, inv_perm),
        lambda: _meta(_features_shape(bot_out, T)),
        lambda: _interaction_flops(B, T, bot_out.shape[1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B, T, Hq, hd) x (B, S, Hkv, hd)^2 -> (B, T, Hq, hd) in q's dtype;
    one launch on the card, which picks its own tiles."""
    B, T, Hq, hd = q.shape
    # q·kᵀ and p·v over every (query, key) pair, as the reference's
    # masked jnp attention counts them
    return _launch(
        "flash_attention", q, (q, k, v),
        lambda: attention.flash_attention(q, k, v, causal=causal,
                                          window=window),
        lambda: _contiguous(ref.flash_attention_ref(
            q, k, v, causal=causal, window=window)),
        lambda: _meta(q.shape, q.dtype),
        lambda: 4.0 * B * Hq * T * k.shape[1] * hd, q.dtype)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor,
                 return_lse: bool = False):
    """(B, Hq, hd) x (B, S, Hkv, hd)^2 x (B,) -> (B, Hq, hd) in q's dtype;
    with ``return_lse`` also (B, Hq) fp32, each (b, head)'s natural
    log-sum-exp (a cache split along S combines its slices with it); one
    launch on the card."""
    B, Hq, hd = q.shape

    def meta():
        out = _meta(q.shape, q.dtype)
        return (out, _meta((B, Hq))) if return_lse else out

    return _launch(
        "flash_decode", q, (q, k_cache, v_cache, lengths),
        lambda: attention.flash_decode(q, k_cache, v_cache, lengths,
                                       return_lse),
        lambda: _contiguous(ref.flash_decode_ref(q, k_cache, v_cache,
                                                 lengths, return_lse)),
        meta, lambda: 4.0 * B * Hq * k_cache.shape[1] * hd, q.dtype)
