"""Kernel micro-benchmarks on the card (+ the fused serve-kernel receipt).

Times the nine hand-written kernels through ``repro_torch.kernels.ops``
with CUDA events (one warm-up call an input set, then many launches over
the sets in turn, queued behind a sleep kernel and divided by the count:
``_timing.time_ms``), at two sets of shapes:

  * the reference's serve shape (``_SERVE_SHAPE``: a per-chip slice of
    RM2-small, T=40 R=2^17 L=80 d=32 B=200) and its attention shapes
    (``benchmarks/kernel_bench.py:43-99``);
  * the main path's shapes (drawn as ``chip_smoke.py``'s phases 5-7 draw
    them): RM2-small at full width (R = 4,194,304), rows 1-3 and 7 at
    B = 25 and 200, rows 4-6 at B = 200, row 8 at mixtral-8x7b's widths
    at T = S = 8,192 in bf16, row 9 there at B = 16 over S = 32,768.

Each row prints the kernel's ms, the bytes and operations the call needs,
the least time the card could take for them (``least_time``: the bytes
over HBM bandwidth against the operations over the peak of their type),
the kernel's share of that bound, and the time of the one PyTorch call
that computes the same function: a yardstick, which no path of the port
calls. ``chip_smoke.py`` takes its bounds, yardsticks and input helpers
from here, so its kernel table and this bench count alike; its own
CUDA-event times are host-paced, so where a launch outlasts its kernel
they read the host's launch rate, which this bench's leave out.

``--emit-json`` judges the fused serve kernel against the composed
two-kernel path (launch counts from ``ops.launch_counts``, the modeled
HBM traffic, kernel against kernel at the reference's tiny shape and at
B = 200, and the times in turns) and writes ``BENCH_torch_kernels.json``;
its ``scalars.kernel_times`` use the calibration schema ({"us": ...,
"shape": ...}), so ``repro_torch.core.calibration.kernel_times_from`` and
``perf_model.inference_breakdown(calibration=...)`` read it.

On the card the bench runs both sets of shapes; ``--reduced`` runs only
the reference's. ``--device cpu`` runs the plain versions on the host
(the CPU tests): its times are host wall-clocks, not device numbers.

  PYTHONPATH=src python -m benchmarks_torch.kernel_bench [--emit-json]
"""
from __future__ import annotations

import argparse
import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmarks_torch._artifacts import (device_block, print_claims,
                                         write_bench_json)
from benchmarks_torch._timing import time_ms
from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.registry import get_dlrm
from repro_torch.device import resolve_device

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, fp32
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# Serve-path problem size: per-chip slice of the paper's RM2-small config,
# and the reference's attention shapes (prefill block, deep decode cache).
_SERVE_SHAPE = dict(T=40, R=2 ** 17, L=80, d=32, B=200)
_REF_ATTENTION = dict(B=1, T=1024, Hq=8, Hkv=2, hd=64, window=None)
_REF_DECODE = dict(B=4, S=32768, Hq=8, Hkv=2, hd=64)
# The main path: RM2-small at full width; mixtral-8x7b's attention widths
# at T = S = 8,192 (prefill_32k's plain version does not fit) and 16
# caches at decode_32k's depth.
MAIN_CONFIG = "dlrm-rm2-small-unsharded"
MAIN_BATCHES = (25, 200)      # a depth-8 micro-batch of a query; a query
MAIN_ATTENTION = dict(B=1, T=8192, Hq=32, Hkv=8, hd=128, window=4096)
MAIN_DECODE = dict(B=16, S=32768, Hq=32, Hkv=8, hd=128)
# The tiered store's hot rows a table, as a share of its rows (65,536 of
# 4,194,304 at full width, chip_smoke.py's HOT_PER_TABLE), and the skew of
# the stream it is built from and looked up with.
HOT_SHARE = 1 / 64
TIERED_ALPHA = 1.05
LBLK = 8                      # the blocked bag's L-block
N_SETS = 8                    # input sets in turn: at B = 200 past the L2
ITERS = 40                    # timed launches a row (the library: 2/5)
EQUIV_TOL = 1e-5


# ------------------------------------------------------------ bounds
def distinct_rows(ids: torch.Tensor, rows_per_table: int) -> int:
    """Distinct (table, row) pairs of (B, T, L) ids."""
    T = ids.shape[1]
    return torch.unique(
        ids.long() + torch.arange(T, device=ids.device)[None, :, None]
        * rows_per_table).numel()


def least_time(nbytes, flops, peak=FP32_FLOP_PER_S):
    """(ms, "bytes" | "operations", bytes, operations): the larger of bytes
    over HBM bandwidth and operations over their type's peak (fp32 by
    default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def fused_bound(tables, ids, bot):
    """Least time for the fused serve work: bytes the function must move
    (the distinct rows these ids touch, the ids, bot_out, the output) over
    HBM bandwidth, against its fp32 operations over the fp32 peak. For the
    grouped kernel ``tables`` is either group (same d and dtype) and the
    row stride is the larger group's."""
    R, d = tables.shape[1], tables.shape[2]
    B, T, L = ids.shape
    pairs = (T + 1) * T // 2
    nbytes = (distinct_rows(ids, R) * d * tables.element_size()
              + ids.numel() * 4 + bot.numel() * 4 + B * (d + pairs) * 4)
    flops = B * T * L * d + B * pairs * 2 * d
    return least_time(nbytes, flops)


def pairs_bound(bot, pooled):
    """Least time of the interaction: bot_out and pooled read once, the
    output written once, against its fp32 operations."""
    B, T, d = pooled.shape
    pairs = (T + 1) * T // 2
    nbytes = (bot.numel() * bot.element_size()
              + pooled.numel() * pooled.element_size() + B * (d + pairs) * 4)
    return least_time(nbytes, B * pairs * 2 * d)


def cached_pairs_bound(fast, bulk, fi, bi, bot):
    """Least time of the two-tier fused op: the distinct rows of each tier
    that the ids touch, both id tensors, bot_out and the output."""
    B, T, L = fi.shape
    d = fast.shape[2]
    pairs = (T + 1) * T // 2
    rows = distinct_rows(fi, fast.shape[1]) + distinct_rows(bi, bulk.shape[1])
    nbytes = (rows * d * fast.element_size() + 2 * fi.numel() * 4
              + bot.numel() * 4 + B * (d + pairs) * 4)
    return least_time(nbytes, 2 * B * T * L * d + B * pairs * 2 * d)


def bag_bound(tables, ids):
    """Least time of a sum-pool: the distinct rows the ids touch, the ids
    and the (B, T, d) fp32 output, against one add a looked-up element."""
    B, T, L = ids.shape
    d = tables.shape[2]
    nbytes = (distinct_rows(ids, tables.shape[1]) * d * tables.element_size()
              + ids.numel() * 4 + B * T * d * 4)
    return least_time(nbytes, B * T * L * d)


def cached_bag_bound(fast, bulk, fi, bi):
    """Least time of the two-tier bag on ``fast`` and ``bulk`` (a (T, R+1,
    d) tier, or the (R+1, d) tier every table shares): the distinct rows
    the slots touch (per table, or over the shared tier), the ids and the
    output, against two adds a lookup and element."""
    B, T, L = fi.shape
    d = fast.shape[2]
    cold = (distinct_rows(bi, bulk.shape[1]) if bulk.dim() == 3
            else torch.unique(bi).numel())
    rows = distinct_rows(fi, fast.shape[1]) + cold
    nbytes = rows * d * fast.element_size() + 2 * fi.numel() * 4 + B * T * d * 4
    return least_time(nbytes, 2 * B * T * L * d)


def attention_pairs(T, S, causal, window):
    """The (query, key) pairs the attention function weighs: those its
    masks keep, and all S keys for a row whose every key is masked."""
    t = np.arange(T)
    lo = np.maximum(0, t - window + 1) if window is not None else 0 * t
    hi = np.minimum(t, S - 1) if causal else np.full(T, S - 1)
    return int(np.where(lo > hi, S, hi - lo + 1).sum())


def attention_bound(q, k, causal, window):
    """Least time of flash attention: q, k, v read and the output written
    once, against 4 hd operations a weighed pair and head (q.k and p.v) at
    the peak of the inputs' type (bf16 on the tensor cores)."""
    B, T, Hq, hd = q.shape
    S = k.shape[1]
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    flops = 4 * B * Hq * hd * attention_pairs(T, S, causal, window)
    return least_time(nbytes, flops, BF16_FLOP_PER_S
                      if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S)


def decode_bound(q, k_cache, lengths):
    """Least time of flash decode: the valid prefix of both caches (all S
    rows where the length is 0), q, lengths and the output, against 4 hd
    operations a row and query head."""
    _, Hq, hd = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    n = lengths.clamp(max=S)
    rows = int(torch.where(n <= 0, S, n).sum())
    nbytes = (2 * rows * Hkv * hd * k_cache.element_size()
              + 2 * q.numel() * q.element_size()
              + lengths.numel() * lengths.element_size())
    return least_time(nbytes, 4 * Hq * hd * rows, BF16_FLOP_PER_S
                      if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S)


# --------------------------------------------------------- yardsticks
def library_pairs(bot, pooled, li, lj):
    """torch.bmm + the tril gather: the interaction's library yardstick."""
    a = torch.cat([bot[:, None, :], pooled], dim=1).float()
    f = torch.bmm(a, a.transpose(1, 2))
    return torch.cat([bot.float(), f[:, li, lj]], dim=1)


def library_bag(tables, ids):
    """One F.embedding_bag(mode="sum") call over the flattened tables."""
    T, R, d = tables.shape
    B, _, L = ids.shape
    t = torch.arange(T, device=ids.device)[None, :, None] * R
    flat = (ids.long() + t).view(B * T, L)
    return torch.nn.functional.embedding_bag(
        flat, tables.view(T * R, d), mode="sum").view(B, T, d)


def library_version(tables, ids, bot, li, lj):
    """F.embedding_bag(mode="sum") + the interaction's yardstick."""
    return library_pairs(bot, library_bag(tables, ids), li, lj)


def library_grouped(tf, tb, ids, bot, inv, li, lj):
    """Per-group F.embedding_bag, cat, index_select(inv_perm), bmm and the
    tril gather: the grouped kernel's library yardstick."""
    n = tf.shape[0]
    pooled = torch.cat([library_bag(tf, ids[:, :n]),
                        library_bag(tb, ids[:, n:])], dim=1)
    return library_pairs(bot, pooled.index_select(1, inv), li, lj)


def library_cached(fast, bulk, fast_idx, bulk_idx):
    """Two F.embedding_bag(mode="sum") calls, one a tier (the shared tier
    read at its positions directly), added: the cached bag's yardstick."""
    if bulk.dim() == 3:
        cold = library_bag(bulk, bulk_idx)
    else:
        B, T, L = bulk_idx.shape
        cold = torch.nn.functional.embedding_bag(
            bulk_idx.view(B * T, L), bulk, mode="sum").view(B, T, -1)
    return library_bag(fast, fast_idx) + cold


def _mask(T, S, causal, window, device):
    t = torch.arange(T, device=device)[:, None]
    s = torch.arange(S, device=device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        ok &= s <= t
    if window is not None:
        ok &= t - s < window
    return ok


def sdpa_attention(q, k, v, causal, window):
    """F.scaled_dot_product_attention with enable_gqa and a boolean mask:
    the library yardstick of flash attention."""
    ok = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=ok, enable_gqa=True).transpose(1, 2)


def sdpa_attention_expanded(q, k, v, causal, window):
    """The library yardstick where ``sdpa_attention`` does not fit (T = S
    = 32,768: enable_gqa with a mask takes the math path, whose Hq x T x S
    fp32 scores are 137 GB): K and V repeated to the query heads, then one
    F.scaled_dot_product_attention with the boolean mask on the
    memory-efficient backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    ok = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
            v.repeat_interleave(G, 2).transpose(1, 2),
            attn_mask=ok).transpose(1, 2)


def sdpa_decode(q, k_cache, v_cache, lengths):
    """The decode yardstick: one query token, the lengths as a mask."""
    S = k_cache.shape[1]
    ok = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        attn_mask=ok[:, None, None], enable_gqa=True)[:, :, 0]


# ------------------------------------------------------------- inputs
def uniform_tables(T, R, d, gen, dev):
    """Tables at the model's init scale, U(+-1/sqrt(R))."""
    return torch.empty((T, R, d), device=dev).uniform_(
        -R ** -0.5, R ** -0.5, generator=gen)


def uniform_case(B, T, L, R, d, gen, dev):
    """Uniform ids (B, T, L) and bot_out (B, d) ~ U(-1, 1)."""
    ids = torch.randint(0, R, (B, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    bot = torch.empty((B, d), device=dev).uniform_(-1, 1, generator=gen)
    return ids, bot


def stream(cfg: DLRMConfig, first: int, n: int, dev) -> List[torch.Tensor]:
    """n batches (cfg.batch_size each) of the alpha = 1.05 stream."""
    from repro_torch.data.recsys import make_recsys_batch
    return [make_recsys_batch(cfg, first + s, 0, TIERED_ALPHA,
                              device=dev)["indices"] for s in range(n)]


def cut(batches, B, k):
    """Input set k of batch size B: a slice of batch k, or whole batches
    concatenated."""
    if B <= batches[0].shape[0]:
        return batches[k % len(batches)][:B]
    n = B // batches[0].shape[0]
    return torch.cat([batches[(n * k + j) % len(batches)] for j in range(n)])


def decode_lengths(B, S, dev):
    """B cache lengths in [1, S], one draw for every caller that times row
    9 at (B, S): its bound and time depend on them."""
    gen = torch.Generator(device=dev).manual_seed(B * S)
    return torch.randint(1, S + 1, (B,), generator=gen, device=dev)


def aligned_ids(B, T, L, R, lblk, gen, dev):
    """A stream the blocked bag reads block by block: every L-block of
    lblk lookups is the rows [k*lblk, (k+1)*lblk) of a random block k."""
    blk = torch.randint(0, R // lblk, (B, T, L // lblk), generator=gen,
                        device=dev)
    return (blk[..., None] * lblk + torch.arange(lblk, device=dev)).reshape(
        B, T, L).to(torch.int32)


# ------------------------------------------------------------- timing
class Bench:
    """The run's settings and its rows."""

    def __init__(self, dev: torch.device, iters: int, n_sets: int):
        self.dev, self.iters, self.n_sets = dev, iters, n_sets
        self.rows: List[dict] = []
        self.section = "reference"     # the set of shapes being timed

    def time_row(self, kernel, shape, fn, n_sets, bounds, library=None):
        """Time ``fn(k)`` over the input sets beside the mean of their
        bounds and the library call; print and keep the row."""
        ms = time_ms(fn, n_sets, self.iters, self.dev)
        lib = (None if library is None else
               time_ms(library, n_sets, max(1, self.iters * 2 // 5),
                       self.dev))
        b_ms = float(np.mean([b[0] for b in bounds]))
        nbytes = float(np.mean([b[2] for b in bounds]))
        flops = float(np.mean([b[3] for b in bounds]))
        row = dict(kernel=kernel, section=self.section, shape=shape, ms=ms,
                   bytes=nbytes, flops=flops, bound_ms=b_ms,
                   bound_by=bounds[0][1], share_of_bound=b_ms / ms,
                   library_ms=lib)
        print(f"{kernel},{shape},{ms:.4f},{nbytes / 1e6:.2f},"
              f"{flops / 1e9:.3f},{b_ms:.4f},{bounds[0][1]},"
              f"{b_ms / ms:.3f},{'none' if lib is None else f'{lib:.4f}'}")
        self.rows.append(row)


def dlrm_rows(bench: Bench, cfg: DLRMConfig, fused_batches, bag_batch,
              gen, receipt: Optional[dict] = None) -> None:
    """Rows 1-7 at ``cfg``'s widths: rows 1, 2, 3 and 7 at each of
    ``fused_batches``, rows 4, 5 and 6 at ``bag_batch``. Tables (and the
    tiered store built from them at alpha 1.05, ``HOT_SHARE`` of the rows
    hot) are freed as soon as their rows are timed: at full width the
    stacked tables and the store's bulk tier are 21.47 GB each. With
    ``receipt``, the composed-vs-fused judgement at ``bag_batch`` runs on
    the same tables and store and fills it."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.engine.planning import build_auto_plan
    from repro_torch.kernels import fused_serve, ops
    from repro_torch.parallel.plan import plan_table_groups

    dev, n = bench.dev, bench.n_sets
    T, R, d = cfg.num_tables, cfg.rows_per_table, cfg.embed_dim
    L = cfg.lookups_per_table
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=dev)
    wide = -(-max(*fused_batches, bag_batch) // cfg.batch_size)
    batches = stream(cfg, 200, n * wide, dev)
    bag_stream = stream(cfg, 100, n, dev)
    tables = uniform_tables(T, R, d, gen, dev)
    tag = f"T={T} L={L} d={d} R={R} fp32"
    for B in fused_batches:
        sets = [uniform_case(B, T, L, R, d, gen, dev) for _ in range(n)]
        bench.time_row(
            "fused_bag_interactions", f"B={B} {tag}",
            lambda k: ops.fused_bag_interactions(tables, *sets[k]), n,
            [fused_bound(tables, *s) for s in sets],
            lambda k: library_version(tables, *sets[k], li, lj))
        psets = [(torch.empty((B, d), device=dev).uniform_(-1, 1,
                                                            generator=gen),
                  ops.embedding_bag(tables, cut(batches, B, k)))
                 for k in range(n)]
        bench.time_row(
            "interactions", f"B={B} T={T} d={d} fp32 pooled",
            lambda k: ops.interactions(*psets[k]), n,
            [pairs_bound(*p) for p in psets],
            lambda k: library_pairs(*psets[k], li, lj))
        if receipt is not None and B == bag_batch:
            receipt["single"] = sets
    lblk = math.gcd(L, LBLK)
    aligned = [aligned_ids(bag_batch, T, L, R, lblk, gen, dev)
               for _ in range(n)]
    bench.time_row(
        "embedding_bag_blocked", f"B={bag_batch} {tag} lblk={lblk}, aligned",
        lambda k: ops.embedding_bag_blocked(tables, aligned[k], lblk=lblk), n,
        [bag_bound(tables, ids) for ids in aligned],
        lambda k: library_bag(tables, aligned[k]))
    del aligned

    counts = te.measure_row_freq(cfg, TIERED_ALPHA, seed=0, n_batches=4,
                                 device=dev)
    hot = max(1, int(R * HOT_SHARE))
    store = te.build_tiered_tables(tables, counts, hot)
    del counts
    fast, bulk = store.fast, store.bulk
    stag = f"T={T} L={L} d={d} S+1={hot + 1} R+1={R + 1} fp32"
    for B in fused_batches:
        sets = []
        for k in range(n):
            fi, bi = te.translate_indices(store, cut(batches, B, k))
            sets.append((fi, bi, torch.empty((B, d), device=dev).uniform_(
                -1, 1, generator=gen)))
        bench.time_row(
            "fused_cached_bag_interactions",
            f"B={B} {stag}, alpha={TIERED_ALPHA} stream",
            lambda k: ops.fused_cached_bag_interactions(fast, bulk, *sets[k]),
            n, [cached_pairs_bound(fast, bulk, *s) for s in sets],
            lambda k: library_pairs(sets[k][2], library_bag(fast, sets[k][0])
                                    + library_bag(bulk, sets[k][1]), li, lj))
        if receipt is not None and B == bag_batch:
            receipt["tiered"] = sets
    csets = [te.translate_indices(store, ids) for ids in bag_stream]
    bench.time_row(
        "cached_embedding_bag", f"B={bag_batch} {stag}, alpha={TIERED_ALPHA}"
        f" stream", lambda k: ops.cached_embedding_bag(fast, bulk, *csets[k]),
        n, [cached_bag_bound(fast, bulk, *s) for s in csets],
        lambda k: library_cached(fast, bulk, *csets[k]))
    del csets
    if receipt is not None:
        judge_receipt(bench, tables, store, receipt)
    del tables
    phys = [te.translate_indices_packed(store, ids) for ids in bag_stream]
    packed = te.packed_tables(store)
    del store, fast, bulk
    bench.time_row(
        "embedding_bag", f"B={bag_batch} T={T} L={L} d={d} "
        f"rows={packed.shape[1]} (packed store) fp32, alpha={TIERED_ALPHA} "
        f"stream", lambda k: ops.embedding_bag(packed, phys[k]), n,
        [bag_bound(packed, ids) for ids in phys],
        lambda k: library_bag(packed, phys[k]))
    del packed, phys

    plan = build_auto_plan(cfg, 1, alpha=TIERED_ALPHA, device=dev).plan
    groups = plan_table_groups(plan, 1)
    perm = torch.as_tensor(groups.fast_ids + groups.bulk_ids, device=dev)
    inv = torch.as_tensor(groups.inv_perm, device=dev)
    pos = fused_serve.grouped_pos(groups.inv_perm, dev)
    tf = uniform_tables(len(groups.fast_ids), R, d, gen, dev)
    tb = uniform_tables(len(groups.bulk_ids), R, d, gen, dev)
    for B in fused_batches:
        gsets = []
        for _ in range(n):
            ids, bot = uniform_case(B, T, L, R, d, gen, dev)
            gsets.append((ids.index_select(1, perm), bot))
        bench.time_row(
            "fused_grouped_bag_interactions",
            f"B={B} Tf={tf.shape[0]} Tb={tb.shape[0]} L={L} d={d} R={R} fp32",
            lambda k: ops.fused_grouped_bag_interactions(
                tf, tb, *gsets[k], inv_perm=groups.inv_perm, pos=pos), n,
            [fused_bound(tf, *s) for s in gsets],
            lambda k: library_grouped(tf, tb, *gsets[k], inv, li, lj))


def attention_rows(bench: Bench, attn: dict, dec: dict, gen) -> None:
    """Row 8 (causal, bf16) and row 9 (bf16, lengths in [1, S]) at the
    given widths."""
    from repro_torch.kernels import ops
    dev = bench.dev
    B, T, Hq, Hkv, hd = (attn[k] for k in ("B", "T", "Hq", "Hkv", "hd"))
    win = attn["window"]
    q = torch.randn((B, T, Hq, hd), device=dev, generator=gen).bfloat16()
    k, v = (torch.randn((B, T, Hkv, hd), device=dev, generator=gen)
            .bfloat16() for _ in range(2))
    bench.time_row(
        "flash_attention", f"B={B} T=S={T} Hq={Hq} Hkv={Hkv} hd={hd} causal "
        f"window={win} bf16",
        lambda _: ops.flash_attention(q, k, v, causal=True, window=win), 1,
        [attention_bound(q, k, True, win)],
        lambda _: sdpa_attention(q, k, v, True, win))
    del q, k, v
    B, S, Hq, Hkv, hd = (dec[k] for k in ("B", "S", "Hq", "Hkv", "hd"))
    kc, vc = (torch.randn((B, S, Hkv, hd), device=dev, generator=gen)
              .bfloat16() for _ in range(2))
    dq = torch.randn((B, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = decode_lengths(B, S, dev)
    bench.time_row(
        "flash_decode", f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} bf16, "
        f"lengths in [1, S]",
        lambda _: ops.flash_decode(dq, kc, vc, lens), 1,
        [decode_bound(dq, kc, lens)],
        lambda _: sdpa_decode(dq, kc, vc, lens))


# ------------------------------------------------------------ receipt
def hbm_traffic_model(T, L, d, B) -> dict:
    """The reference's modeled HBM traffic of the embedding side: the
    composed path round-trips the (B, T, d) pooled tensor (the bag writes
    it, the interaction reads it back); the fused kernel keeps it on
    chip."""
    s1 = T + 1
    row_read = B * T * L * d * 4
    pooled_rt = 2 * B * T * d * 4
    bot_read = B * d * 4
    out_write = B * s1 * s1 * 4
    composed = row_read + pooled_rt + bot_read + out_write
    fused = row_read + bot_read + out_write
    return {"shape": f"B{B} T{T} L{L} d{d}",
            "composed_bytes": composed, "fused_bytes": fused,
            "pooled_roundtrip_bytes_eliminated": pooled_rt,
            "fraction_of_composed": pooled_rt / composed}


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def composed_single(tables, ids, bot):
    """Row 4 then row 7: the composed single-tier serve forward."""
    from repro_torch.kernels import ops
    return ops.interactions(bot, ops.embedding_bag(tables, ids))


def composed_tiered(fast, bulk, fi, bi, bot):
    """Row 6 then row 7: the composed two-tier serve forward."""
    from repro_torch.kernels import ops
    return ops.interactions(bot, ops.cached_embedding_bag(fast, bulk, fi, bi))


def tiny_equivalence(dev) -> Dict[str, float]:
    """Row 1 against rows 4 + 7, and row 2 against rows 6 + 7, at the
    reference's tiny shape (B=6 T=3 L=4 R=16 d=8; the port's kernels have
    no batch blocks to pad: a cluster of blocks serves a sample), the
    two-tier store a frequency-built cache of 6 rows a table."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(1)
    Bt, Tt, Lt, Rt, dt = 6, 3, 4, 16, 8
    tabs = torch.randn((Tt, Rt, dt), device=dev, generator=gen)
    ids = torch.randint(0, Rt, (Bt, Tt, Lt), generator=gen, device=dev,
                        dtype=torch.int32)
    bot = torch.randn((Bt, dt), device=dev, generator=gen)
    errs = {"single": _max_err(ops.fused_bag_interactions(tabs, ids, bot),
                               composed_single(tabs, ids, bot))}
    freq = torch.randint(0, 100, (Tt, Rt), generator=gen, device=dev)
    store = te.build_tiered_tables(tabs, freq, 6)
    tiers = (store.fast, store.bulk, *te.translate_indices(store, ids), bot)
    errs["tiered"] = _max_err(ops.fused_cached_bag_interactions(*tiers),
                              composed_tiered(*tiers))
    return errs


def judge_receipt(bench: Bench, tables, store, receipt: dict) -> None:
    """On the B = ``bag_batch`` inputs ``dlrm_rows`` kept: the fused kernel
    against the composed path (values; launches counted by
    ``ops.launch_counts``, read before and after one forward each and left
    as they are; CUDA-event times in turns, fused, composed, composed,
    fused, over 3 rounds)."""
    from repro_torch.kernels import ops
    single, tiered = receipt.pop("single"), receipt.pop("tiered")
    ids, bot = single[0]
    tiers = (store.fast, store.bulk, *tiered[0])
    receipt["err_single"] = _max_err(
        ops.fused_bag_interactions(tables, ids, bot),
        composed_single(tables, ids, bot))
    receipt["err_tiered"] = _max_err(ops.fused_cached_bag_interactions(*tiers),
                                     composed_tiered(*tiers))
    receipt["shape"] = f"B{ids.shape[0]} T{ids.shape[1]} L{ids.shape[2]} " \
                       f"d{bot.shape[1]} R{tables.shape[1]}"

    launches = {}
    for label, forward in (
            ("composed_single", lambda: composed_single(tables, ids, bot)),
            ("fused_single", lambda: ops.fused_bag_interactions(
                tables, ids, bot)),
            ("composed_tiered", lambda: composed_tiered(*tiers)),
            ("fused_tiered", lambda: ops.fused_cached_bag_interactions(
                *tiers))):
        before = sum(ops.launch_counts.values())
        forward()
        launches[label] = sum(ops.launch_counts.values()) - before
    receipt["launches"] = launches

    n = len(single)
    fused = lambda k: ops.fused_bag_interactions(tables, *single[k])
    comp = lambda k: composed_single(tables, *single[k])
    times = {"fused": [], "composed": []}
    for r in range(3):
        order = (("fused", fused), ("composed", comp))
        for label, fn in (order if r % 2 == 0 else order[::-1]):
            times[label].append(time_ms(fn, n, bench.iters, bench.dev))
    receipt["times_ms"] = {k: statistics.median(v) for k, v in times.items()}


def receipt_claims(receipt: dict, tiny: Dict[str, float], on_card: bool):
    """The claims of ``--emit-json`` and the scalars behind them."""
    claims, scalars = [], {}
    T, L, d, B = (_SERVE_SHAPE[k] for k in ("T", "L", "d", "B"))
    traffic = hbm_traffic_model(T, L, d, B)
    scalars["hbm_traffic_model"] = traffic
    pooled_rt = traffic["pooled_roundtrip_bytes_eliminated"]
    claims.append((
        "fused_hbm_roundtrip_eliminated",
        traffic["fused_bytes"] == traffic["composed_bytes"] - pooled_rt
        and pooled_rt > 0,
        f"(B,T,d) pooled HBM round-trip eliminated: {pooled_rt / 2**20:.2f}"
        f" MiB/step ({100 * traffic['fraction_of_composed']:.0f}% of "
        f"composed embedding-side traffic, modeled at {traffic['shape']})"))
    for tier, rows in (("single", "row 1 vs rows 4 + 7"),
                       ("tiered", "row 2 vs rows 6 + 7")):
        small, big = tiny[tier], receipt[f"err_{tier}"]
        claims.append((
            f"fused_matches_composed_{tier}",
            small <= EQUIV_TOL and big <= EQUIV_TOL,
            f"{rows}: max|delta|={small:.1e} at B6 T3 L4 d8, {big:.1e} at "
            f"{receipt['shape']} (tolerance {EQUIV_TOL:.0e})"))
    if on_card:
        lc = receipt["launches"]
        scalars["launches"] = lc
        r_single = lc["composed_single"] / max(lc["fused_single"], 1)
        r_tiered = lc["composed_tiered"] / max(lc["fused_tiered"], 1)
        claims.append((
            "fused_launch_reduction",
            lc["fused_single"] == 1 and lc["fused_tiered"] == 1
            and r_single >= 1.5 and r_tiered >= 1.5,
            f"kernel launches per serve forward (ops.launch_counts): "
            f"{lc['composed_single']} -> {lc['fused_single']} single-tier "
            f"({r_single:.1f}x), {lc['composed_tiered']} -> "
            f"{lc['fused_tiered']} tiered ({r_tiered:.1f}x)"))
        t = receipt["times_ms"]
        scalars["fused_vs_composed_ms"] = {**t, "shape": receipt["shape"]}
        claims.append((
            "fused_faster_than_composed", t["fused"] < t["composed"],
            f"row 1 {t['fused']:.4f} ms vs rows 4 + 7 {t['composed']:.4f} ms"
            f" at {receipt['shape']} ({t['composed'] / t['fused']:.2f}x; "
            f"CUDA events, medians of 3 rounds in turns)"))
    else:
        scalars["launches"] = ("counted on the card only: a CPU tensor runs "
                               "the plain versions")
    return claims, scalars


def kernel_times(rows: List[dict], batch: int) -> dict:
    """Calibration-schema times: each kernel's row at ``batch`` (the
    query) where it has one, else its last row."""
    by_kernel: Dict[str, List[dict]] = {}
    for row in rows:
        by_kernel.setdefault(row["kernel"], []).append(row)
    out = {}
    for name, kept in by_kernel.items():
        row = ([r for r in kept if f"B={batch} " in r["shape"]] or kept)[-1]
        out[name] = {"us": round(row["ms"] * 1e3, 3), "shape": row["shape"]}
    return out


def run(dev: torch.device, reduced: bool, iters: int, n_sets: int,
        receipt: bool) -> tuple:
    """Both sets of shapes (the reference's only under ``reduced``);
    returns (the bench, the receipt's inputs or None)."""
    bench = Bench(dev, iters, n_sets)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"# kernel micro-bench through repro_torch.kernels.ops on {dev}"
          f"{'' if dev.type == 'cuda' else ' (host wall-clock of the plain versions: not device numbers)'}")
    print("kernel,shape,ms,MB,GFLOP,bound_ms,bound_by,share_of_bound,"
          "library_ms")
    T, R, L, d, B = (_SERVE_SHAPE[k] for k in ("T", "R", "L", "d", "B"))
    serve = DLRMConfig(name="serve-shape", num_tables=T, lookups_per_table=L,
                       embed_dim=d, rows_per_table=R, batch_size=B)
    rec = {} if receipt else None
    dlrm_rows(bench, serve, (B,), B, gen, rec if reduced else None)
    attention_rows(bench, _REF_ATTENTION, _REF_DECODE, gen)
    if not reduced:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        bench.section = "main"
        cfg = get_dlrm(MAIN_CONFIG)
        dlrm_rows(bench, cfg, MAIN_BATCHES, cfg.batch_size, gen, rec)
        attention_rows(bench, MAIN_ATTENTION, MAIN_DECODE, gen)
    return bench, rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' times the plain "
                         "versions on the host")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's shapes only")
    ap.add_argument("--emit-json", action="store_true",
                    help="judge the fused serve claims, write "
                         "BENCH_torch_kernels.json")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bench, rec = run(dev, args.reduced, ITERS, N_SETS, args.emit_json)
    if not args.emit_json:
        return 0
    claims, scalars = receipt_claims(rec, tiny_equivalence(dev),
                                     dev.type == "cuda")
    scalars["kernel_times"] = kernel_times(
        bench.rows, _SERVE_SHAPE["B"] if args.reduced
        else get_dlrm(MAIN_CONFIG).batch_size)
    scalars["rows"] = bench.rows
    block = device_block(dev)
    print_claims("kernels", claims, block)
    write_bench_json("kernels", claims, scalars, dev, args.out_dir)
    return 0 if all(ok for _, ok, _ in claims) else 1


if __name__ == "__main__":
    raise SystemExit(main())
