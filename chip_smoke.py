#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root, on a CUDA host

Phases; any failure exits non-zero:

  1. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all at once) and print the card (nvidia-smi
     name and power limit);
  2. hold each kernel's wrapper against its plain PyTorch version on the
     card: the serve kernels (fused_bag_interactions and
     fused_grouped_bag_interactions) at the main path's shapes, and all
     four kernels at edge shapes (d = 128 and 256, empty groups, repeated,
     poisoned-row and out-of-range ids);
  3. drive the plan="none" main path:
     ``Engine(get_dlrm("dlrm-rm2-small-unsharded"))`` at full width (40
     tables x 4,194,304 rows x 32, fp32, random weights from a seed), at
     the planner's default pipeline depth, serves queries through
     ``run_serial``, ``run_open_loop`` and ``submit``; the fused kernel's
     launch count must equal the sum over flushes of the resolved depth,
     and the probs must be finite, in (0, 1), and agree with the composed
     (plain) path and with the CPU path;
  4. drive the plan="auto" main path: the planner places the same weights
     in a fast and a bulk table group and the session serves them through
     the grouped kernel (launches = sum of resolved depths, and the
     single-group kernel is not launched); its probs must agree with the
     plan="none" session, with its own composed path and with a session
     under an interleaved concrete ShardingPlan. Closed-loop p50/p99 at
     the default depth and at depth 1, and a profile of both flushes;
  5. time the serve kernels with CUDA events beside their bound, their
     plain versions and one library yardstick;
  6. the tiered runtime at full width: a two-tier store built from the
     same weights by ``measure_row_freq`` (alpha 1.05) with 65,536 hot
     rows a table serves 4 batches of the stream through the cached-bag
     kernel (6a) and, once the stacked tables are freed, 4 through the
     packed embedding-bag kernel (6b; 4 launches each), all against
     ``embedding_bag_ref``; both kernels are also held against their
     plain versions and timed;
  7. the kernels API's other four ops, each through ``kernels.ops`` with
     the launch counts zeroed just before and read just after:
     a. (run between phases 6a and 6b, while the stacked tables and the
        store are both resident) fused_cached_bag_interactions on the store at
        B = 25, 100, 200 and 800 of the alpha = 1.05 stream, held against
        its plain version and against fused_bag_interactions on the
        stacked tables, and interactions on pooled rows of the same
        batches; a bf16 store, d = 128, non-zero pad rows and other edge
        shapes; both timed;
     b. (last) flash_attention at mixtral-8x7b's widths (Hq = 32, Hkv = 8,
        hd = 128, window 4,096, causal, bf16) at the prefill_32k length
        (T = S = 32,768, batch cut from 32 to 1), held against its plain
        version at T = S = 8,192 and on sampled rows at 32,768, with edge
        cases (hd = 120, internlm2-1.8b's 16/8 heads, non-causal, T != S,
        fully masked rows, fp32), each row also held to its own norm;
        flash_decode at decode_32k (B = 128,
        S = 32,768, lengths in [1, S]), held against its plain version at
        B = 8 with lengths 0 and S, a poisoned tail and edge shapes; both
        timed.

Each phase prints its peak device memory. The line before the last holds
the per-kernel JSON (every TPU kernel of the JAX package: the eight ported
and the one still to port); the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

CONFIG = "dlrm-rm2-small-unsharded"
# Kernel vs plain version: fp32 allclose at the contract of the tests.
# Inputs are drawn at the model's init scale (tables U(+-1/sqrt(R)),
# bot_out U(+-1)), where fp32 summation order moves results by ~1e-7.
RTOL = ATOL = 1e-5
# At R = 4,194,304 a pooled.pooled feature is ~4e-5 and a pooled one
# ~4e-3, so ATOL alone would let a 30% error there pass: those features
# are also held to their own scale, max|err| <= SCALED_TOL * max|want|
# over the pooled.pooled block of an interaction output, or over a pool.
SCALED_TOL = 1e-5
# Attention kernel vs plain version: the contract of tests/test_kernels.py.
ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# An attention row that weighs n keys of N(0, 1) values has |out| ~
# sqrt(e / n), ~0.026 over a 4,096-key window, so ATTN_TOL alone would
# pass an error the size of the answer there: each (b, t, h) row is also
# held to its own scale, ||got - want|| <= ATTN_ROW_TOL * ||want||. bf16
# rounding of the output (and of P on the tensor cores) reads ~2e-3.
ATTN_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, fp32
# outside the tensor cores, and dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# mixtral-8x7b (src/repro/configs/mixtral_8x7b.py) and the LM shape cells
# prefill_32k and decode_32k (src/repro/configs/base.py:184-185).
MIXTRAL = dict(Hq=32, Hkv=8, hd=128, window=4096)
PREFILL_T = DECODE_S = 32_768
DECODE_B = 128
# The plain version of flash attention holds (Hkv, G, T, S) fp32 scores:
# 8.6 GB at T = S = 8,192 (137 GB at 32,768), and the library's GQA path
# expands K and V per query head: flash decode is timed beside both at 16
# caches of S rows.
CHECK_T = 8192
TIME_DECODE_B = 16
HOT_PER_TABLE = 65_536
TIERED_ALPHA = 1.05
GB = 1e9

KERNELS = {
    "fused_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:134"),
    "fused_cached_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:181"),
    "fused_grouped_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:244"),
    "embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:45"),
    "cached_embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/cached_embedding_bag.py:47"),
    "interactions": (
        "src/repro_torch/kernels/csrc/interactions.cu",
        "src/repro/kernels/interactions.py:31"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:90"),
    "flash_decode": (
        "src/repro_torch/kernels/csrc/flash_decode.cu",
        "src/repro/kernels/flash_decode.py:75"),
}
NOT_PORTED = [{"name": "embedding_bag_blocked",
               "replaces": "src/repro/kernels/embedding_bag.py:107",
               "status": "to port (ROADMAP B5)"}]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def peak_line(phase: str) -> None:
    torch.cuda.synchronize()
    print(f"[memory] {phase}: peak allocated "
          f"{torch.cuda.max_memory_allocated() / GB:.2f} GB, now "
          f"{torch.cuda.memory_allocated() / GB:.2f} GB")
    torch.cuda.reset_peak_memory_stats()


def close(kernel, name, got, want, errs, nan_ok=False, pairs=None):
    """Hold a kernel's output against its plain version: same NaN pattern,
    fp32 allclose, and (``pairs`` = (T, d) of an interaction output) the
    pooled.pooled block against its own scale."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{kernel} {name}: shape "
                                   f"{tuple(got.shape)}")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan) and (nan_ok or not nan.any()),
          f"{kernel} {name}: NaN pattern differs from the plain version")
    g, w = got[~nan], want[~nan]
    abs_err = (g - w).abs().max().item() if g.numel() else 0.0
    rel_err = ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item() \
        if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, rtol=RTOL, atol=ATOL))
    scaled, text = 0.0, ""
    if pairs is None:                  # a pool: the whole output's scale
        gp, wp, text = got, want, " pooled err/scale"
    elif pairs[0] > 1:
        T, d = pairs
        lj = torch.tril_indices(T + 1, T + 1, offset=-1,
                                device=got.device)[1]
        pp = d + torch.nonzero(lj >= 1)[:, 0]
        gp, wp, text = got[:, pp], want[:, pp], " pooled.pooled err/scale"
    if text:
        keep = ~torch.isnan(wp)
        scale = wp[keep].abs().max().item() if keep.any() else 0.0
        if scale > 0:
            scaled = (gp - wp)[keep].abs().max().item() / scale
        text = f"{text}={scaled:.3e}"
    ok_scaled = scaled <= SCALED_TOL
    print(f"[kernel] {kernel} {name}: max_abs_err={abs_err:.3e} "
          f"max_rel_err={rel_err:.3e}{text} "
          f"{'ok' if ok and ok_scaled else 'OVER TOLERANCE'}")
    check(ok, f"{kernel} {name}: kernel disagrees with its plain version "
              f"(rtol={RTOL}, atol={ATOL})")
    check(ok_scaled, f"{kernel} {name}: pooled features off by "
                     f"{scaled:.3e} of their scale (limit {SCALED_TOL})")
    record(errs, kernel, abs_err, scaled)


def record(errs, kernel, abs_err, scaled):
    """Keep a case's errors: the largest absolute error and the largest
    error against its own scale go into the kernels line."""
    errs.setdefault(kernel, []).append(abs_err)
    errs.setdefault((kernel, "scaled"), []).append(scaled)


# ---------------------------------------------------------------- phase 2
def draw_case(B, T, L, d, R, dtype, gen, dev, tables=None):
    bound = R ** -0.5
    if tables is None:
        tables = torch.empty((T, R, d), device=dev).uniform_(
            -bound, bound, generator=gen).to(dtype)
    ids = torch.randint(0, R, (B, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    bot = torch.empty((B, d), device=dev).uniform_(-1, 1, generator=gen)
    return tables, ids, bot


def compare(name, tables, ids, bot, errs, nan_ok=False):
    from repro_torch.kernels import fused_serve, ref
    got = fused_serve.fused_bag_interactions(tables, ids, bot)
    want = ref.fused_bag_interactions_ref(tables, ids, bot)
    close("fused_bag_interactions", name, got, want, errs, nan_ok,
          pairs=(ids.shape[1], bot.shape[1]))


def compare_grouped(name, tf, tb, ids, bot, inv, errs, nan_ok=False):
    """The grouped kernel on (tf, tb) against its plain version."""
    from repro_torch.kernels import fused_serve, ref
    pos = fused_serve.grouped_pos(inv, ids.device)
    got = fused_serve.fused_grouped_bag_interactions(tf, tb, ids, bot, pos)
    want = ref.fused_grouped_bag_interactions_ref(tf, tb, ids, bot, inv)
    close("fused_grouped_bag_interactions", name, got, want, errs, nan_ok,
          pairs=(ids.shape[1], bot.shape[1]))


def compare_bags(name, tables, ids, gen, errs, nan_ok=False):
    """The embedding-bag kernel on (tables, ids), and the cached bag with
    ``tables`` as its bulk tier beside a small random fast tier."""
    from repro_torch.kernels import embedding_bags, ref
    close("embedding_bag", name, embedding_bags.embedding_bag(tables, ids),
          ref.embedding_bag_ref(tables, ids), errs, nan_ok)
    fast = torch.empty((tables.shape[0], 9, tables.shape[2]),
                       device=ids.device).uniform_(-1, 1, generator=gen).to(
        tables.dtype)
    fi = torch.randint(0, 9, ids.shape, generator=gen, device=ids.device,
                       dtype=torch.int32)
    close("cached_embedding_bag", name,
          embedding_bags.cached_embedding_bag(fast, tables, fi, ids),
          ref.cached_embedding_bag_ref(fast, tables, fi, ids), errs, nan_ok)


def shuffled(T, gen):
    return tuple(torch.randperm(T, generator=gen,
                                device=gen.device).tolist())


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {}
    R = 4_194_304
    full = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        full = (None if full is None else full.to(dtype))
        # the plan="none" main path's micro-batch shapes at depth 8 (25 for
        # a one-query flush, 100 for a capacity flush), and whole batches
        for B in (25, 100, 200, 800) + ((1,) if dtype == torch.float32
                                        else ()):
            case = draw_case(B, 40, 80, 32, R, dtype, gen, dev, full)
            full = case[0]
            compare(f"B={B} T=40 L=80 d=32 R={R} {tag}", *case, errs)
        # the plan="auto" main path: Tf = Tb = 20, identity order, at the
        # micro-batch (25, 100), query (200) and capacity (800) shapes
        fast, bulk = full[:20], full[20:]
        for B in (25, 100, 200, 800):
            _, ids, bot = draw_case(B, 40, 80, 32, R, dtype, gen, dev, full)
            compare_grouped(f"B={B} Tf=20 Tb=20 L=80 d=32 R={R} {tag}",
                            fast, bulk, ids, bot, tuple(range(40)), errs)
        _, ids, bot = draw_case(200, 40, 80, 32, R, dtype, gen, dev, full)
        compare_grouped(f"B=200 Tf=20 Tb=20 interleaved inv_perm {tag}",
                        fast, bulk, ids, bot, shuffled(40, gen), errs)
        del fast, bulk
    del full, case
    torch.cuda.empty_cache()
    for B, T, L, d, R in ((37, 3, 5, 32, 1000), (16, 8, 4, 128, 128),
                          (16, 1, 4, 32, 64), (8, 4, 8, 256, 64),
                          (4, 100, 2, 128, 64)):   # 52 KB of shared memory
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            tables, ids, bot = draw_case(B, T, L, d, R, dtype, gen, dev)
            compare(f"B={B} T={T} L={L} d={d} R={R} {tag}", tables, ids,
                    bot, errs)
            compare_bags(f"B={B} T={T} L={L} d={d} R={R} {tag}", tables,
                         ids, gen, errs)
            # grouped: split in two, the bulk group with other row counts
            tf = tables[:T // 2]
            tb = draw_case(1, T - T // 2, 1, d, R // 2 + 1, dtype, gen,
                           dev)[0]
            ids[:, T // 2:] %= R // 2 + 1
            compare_grouped(f"B={B} Tf={T // 2} Tb={T - T // 2} L={L} "
                            f"d={d} Rf={R} Rb={R // 2 + 1} {tag}", tf, tb,
                            ids, bot, shuffled(T, gen), errs)
            empty = tables[:0]
            compare_grouped(f"B={B} Tf=0 Tb={T} L={L} d={d} {tag}", empty,
                            tables, ids, bot, shuffled(T, gen), errs)
            compare_grouped(f"B={B} Tf={T} Tb=0 L={L} d={d} {tag}", tables,
                            empty, ids, bot, shuffled(T, gen), errs)
    tables, ids, bot = draw_case(16, 8, 4, 32, 128, torch.float32, gen, dev)
    ids[:] = ids[:, :, :1]                       # one row, L times a bag
    compare("repeated ids", tables, ids, bot, errs)
    compare_bags("repeated ids", tables, ids, gen, errs)
    compare_grouped("repeated ids", tables[:3], tables[3:], ids, bot,
                    shuffled(8, gen), errs)
    for dtype in (torch.float32, torch.bfloat16):
        tables, ids, bot = draw_case(64, 8, 16, 32, 1024, dtype, gen, dev)
        tables[:, 0, :] = float("nan")
        ids.clamp_(min=1)
        compare(f"poisoned row 0 never read ({dtype})", tables, ids, bot,
                errs)
        compare_grouped(f"poisoned row 0 never read ({dtype})", tables[:5],
                        tables[5:], ids, bot, shuffled(8, gen), errs)
        compare_bags(f"poisoned row 0 never read ({dtype})", tables, ids,
                     gen, errs)
    tables, ids, bot = draw_case(8, 4, 6, 32, 64, torch.float32, gen, dev)
    ids[0, 0, 0], ids[1, 1, 1], ids[2, 2, 2] = -1, 64, -65
    compare("out-of-range ids read as jnp.take does", tables, ids, bot, errs,
            nan_ok=True)
    compare_grouped("out-of-range ids read as jnp.take does", tables[:1],
                    tables[1:], ids, bot, (3, 0, 2, 1), errs, nan_ok=True)
    compare_bags("out-of-range ids read as jnp.take does", tables, ids, gen,
                 errs, nan_ok=True)
    peak_line("phase 2 (kernels vs plain versions)")
    return {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------- phase 3
def record_flush_depths(sess):
    """Note the resolved pipeline depth of every flush the session runs
    (each flush launches the serve kernel once per micro-batch)."""
    depths = []
    execute = sess._execute

    def recorded(queries):
        samples = sess._padded_count(len(queries)) * sess.query_size
        depths.append(sess.depth_for_samples(samples))
        return execute(queries)

    sess._execute = recorded
    return depths


def submit_queries(cfg):
    from repro_torch.data.recsys import make_recsys_batch
    return [{k: v for k, v in make_recsys_batch(cfg, 1000 + i).items()
             if k != "labels"} for i in range(4)]


def drive(sess, qps):
    """The main path: 8 serial queries, 16 open-loop, 4 submitted (the 4th
    fills the batch). Launch counts are zeroed just before and read just
    after. Returns (serial, open_loop, futures, launches, flush depths)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    depths = record_flush_depths(sess)
    ops.reset_launch_counts()
    serial = sess.run_serial(8, metrics=reg)
    open_loop = sess.run_open_loop(16, qps=qps, metrics=reg)
    futs = [sess.submit(q, now=i * 1e-4)
            for i, q in enumerate(submit_queries(sess.cfg))]
    launches = dict(ops.launch_counts)
    del sess._execute                  # the session's own method again
    flushes = reg.snapshot()["flush_service_ms"]["count"] + 1
    check(len(depths) == flushes, f"{len(depths)} recorded flushes, "
                                  f"{flushes} counted")
    check(all(f.done for f in futs), "submit path left queries pending")
    print(f"[main] launches {launches} over {flushes} flushes (8 serial + "
          f"{flushes - 9} open-loop + 1 submit) at resolved depths "
          f"{depths} (sum {sum(depths)})")
    print(serial.summary())
    print(open_loop.summary())
    probs = np.stack([f.probs for f in futs])
    check(probs.shape == (4, sess.cfg.batch_size), f"probs shape "
                                                   f"{probs.shape}")
    check(bool(np.isfinite(probs).all() and (probs > 0).all()
               and (probs < 1).all()), "probs not finite in (0, 1)")
    return serial, open_loop, futs, launches, depths


def phase_main_none(dev):
    from repro_torch.configs import get_dlrm
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.engine import Engine

    cfg = get_dlrm(CONFIG)
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    t0 = time.perf_counter()
    eng = Engine(cfg)                                  # device None: the card
    sess = eng.serve_session(max_batch_queries=4, warmup=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] {cfg.name}: T={cfg.num_tables} R={cfg.rows_per_table} "
          f"d={cfg.embed_dim} L={cfg.lookups_per_table} B={cfg.batch_size} "
          f"tables {table_bytes / GB:.2f} GB fp32 on {sess.device}; "
          f"session built in {build_s:.2f} s, peak allocated "
          f"{peak / GB:.2f} GB")
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    check(sess.params["tables"].is_cuda, "tables are not on the card")
    check(peak < 1.05 * table_bytes, "session holds more than one table copy")
    check(eng.pipeline_depth is None, "the default depth is not the "
                                      "planner's")
    print(f"[main] plan=none resolved pipeline depth: "
          f"{sess.depth_for_samples(cfg.batch_size)} at 1 query, "
          f"{sess.depth_for_samples(4 * cfg.batch_size)} at 4 queries")
    s1 = sess.measure_service_time(1)
    s4 = sess.measure_service_time(4)
    print(f"[main] service time a flush: 1 query {s1 * 1e3:.3f} ms, "
          f"4 queries {s4 * 1e3:.3f} ms (median of 5)")
    serial, open_loop, futs, launches, depths = drive(sess, 2.0 / s1)
    check(launches["fused_bag_interactions"] == sum(depths),
          "the kernel's launch count differs from the sum over flushes of "
          "the resolved depth")
    check(launches["fused_grouped_bag_interactions"] == 0,
          "plan=none launched the grouped kernel")

    # the same weights through the composed path (plain PyTorch)
    off = Engine(cfg, fused_serve="off").serve_session(
        max_batch_queries=4, params=sess.params)
    check(off.serve_kernel == "composed", "fused_serve=off is not composed")
    q = make_recsys_batch(cfg, 7)
    fused_p = sess.serve_direct(q["dense"], q["indices"])
    plain_p = off.serve_direct(q["dense"], q["indices"])
    err = float(np.abs(fused_p - plain_p).max())
    print(f"[main] fused vs composed probs, one query: max_abs_err={err:.3e}")
    check(np.allclose(fused_p, plain_p, rtol=RTOL, atol=ATOL),
          "fused and composed probs disagree")

    # reduced config: the card against the CPU path on the same weights
    rcfg = cfg.reduced()
    rs = Engine(rcfg).serve_session(max_batch_queries=2)
    cpu_params = {k: ([{n: t.cpu() for n, t in layer.items()} for layer in v]
                      if isinstance(v, list) else v.cpu())
                  for k, v in rs.params.items()}
    cs = Engine(rcfg, device="cpu").serve_session(max_batch_queries=2,
                                                  params=cpu_params)
    rq = make_recsys_batch(rcfg, 3, device="cpu")
    a = rs.serve_direct(rq["dense"], rq["indices"])
    b = cs.serve_direct(rq["dense"], rq["indices"])
    err_cpu = float(np.abs(a - b).max())
    print(f"[main] reduced config, card vs CPU probs: "
          f"max_abs_err={err_cpu:.3e}")
    check(np.allclose(a, b, rtol=RTOL, atol=ATOL), "card and CPU disagree")
    peak_line("phase 3 (plan=none main path)")
    return sess, launches, serial, open_loop


# ---------------------------------------------------------------- phase 4
def agree(name, got, want):
    err = float(np.abs(got - want).max())
    print(f"[auto] {name}: max_abs_err={err:.3e}")
    check(np.allclose(got, want, rtol=RTOL, atol=ATOL), f"{name} disagree")


def own_table_bytes(sess):
    return sum(sess.params[k].numel() * sess.params[k].element_size()
               for k in ("tables_fast", "tables_bulk"))


def phase_main_auto(dev, none):
    """plan="auto" on the plan="none" session's weights. Returns the
    session (alive for the timing phase) and what the phase measured."""
    from repro_torch.engine import Engine

    cfg = none.cfg
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    t0 = time.perf_counter()
    eng = Engine(cfg, plan="auto")
    sess = eng.serve_session(max_batch_queries=4, params=none.params,
                             warmup=True)
    torch.cuda.synchronize()
    print(eng.plan_report("inference").summary())
    print(f"[auto] session built in {time.perf_counter() - t0:.2f} s "
          f"(profile, plan, split of the tables); its own tables "
          f"{own_table_bytes(sess) / GB:.2f} GB")
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    check(eng.plan_report("inference").serve_kernel == "fused",
          "the plan report does not record the fused kernel")
    check(own_table_bytes(sess) == table_bytes,
          "the planned session's tables are not exactly one copy")
    depth1, depth4 = (sess.depth_for_samples(q * cfg.batch_size)
                      for q in (1, 4))
    print(f"[auto] resolved pipeline depth: {depth1} at 1 query, {depth4} "
          f"at 4 queries")
    s1 = sess.measure_service_time(1)
    s4 = sess.measure_service_time(4)
    print(f"[auto] service time a flush: 1 query {s1 * 1e3:.3f} ms, "
          f"4 queries {s4 * 1e3:.3f} ms (median of 5)")
    serial, open_loop, futs, launches, depths = drive(sess, 2.0 / s1)
    check(launches["fused_grouped_bag_interactions"] == sum(depths),
          "the grouped kernel's launch count differs from the sum over "
          "flushes of the resolved depth")
    check(launches["fused_bag_interactions"] == 0,
          "plan=auto launched the single-group kernel")
    queries = submit_queries(cfg)
    want = np.stack([none.serve_direct(q["dense"], q["indices"])
                     for q in queries])
    agree("plan=auto (submit) vs plan=none, same weights",
          np.stack([f.probs for f in futs]), want)
    off = Engine(cfg, plan=sess.plan, fused_serve="off").serve_session(
        max_batch_queries=4, params=sess.params)
    check(off.serve_kernel == "composed", "fused_serve=off is not composed")
    agree("plan=auto composed vs fused",
          off.serve_direct(queries[0]["dense"], queries[0]["indices"]),
          sess.serve_direct(queries[0]["dense"], queries[0]["indices"]))
    del off
    pinned = {k: Engine(cfg, plan=sess.plan, pipeline_depth=k).serve_session(
        max_batch_queries=4, params=sess.params, warmup=True)
        for k in (1, 2, 4)}
    big = {k: torch.cat([q[k] for q in queries]) for k in queries[0]}
    want = sess.serve_direct(big["dense"], big["indices"])
    for k, other in pinned.items():
        agree(f"plan=auto depth {k} vs planner depth, 4 queries",
              other.serve_direct(big["dense"], big["indices"]), want)
    # the cost of the planner's depth choice, closed loop: each depth twice,
    # in turns (1, 2, 4, planner, planner, 4, 2, 1)
    order = [(f"depth {k}", s) for k, s in pinned.items()] + [
        (f"planner depth {depth1}", sess)]
    for label, s in order + order[::-1]:
        rep = s.run_serial(16)
        print(f"[auto] closed loop, {label}: 16 queries p50 "
              f"{rep.p50_ms:.4f} ms p99 {rep.p99_ms:.4f} ms")
    peak_line("phase 4 (plan=auto main path; two table copies resident)")
    return sess, pinned[1], dict(launches=launches, serial=serial,
                                 open_loop=open_loop, depths=depths)


def phase_interleaved(none, auto_plan):
    """A concrete ShardingPlan with interleaved tiers (even tables fast)
    on the same weights: it must agree with plan=none."""
    from repro_torch.core.planner import TablePlacement
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops

    cfg = none.cfg
    plan = dataclasses.replace(auto_plan, placements=tuple(
        TablePlacement(t, "fast", "table_wise", 0) if t % 2 == 0
        else TablePlacement(t, "bulk", "row_wise", None)
        for t in range(cfg.num_tables)))
    sess = Engine(cfg, plan=plan).serve_session(max_batch_queries=4,
                                                params=none.params)
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    queries = submit_queries(cfg)
    big = {k: torch.cat([q[k] for q in queries]) for k in queries[0]}
    ops.reset_launch_counts()
    got = sess.serve_direct(big["dense"], big["indices"])
    n = ops.launch_counts["fused_grouped_bag_interactions"]
    check(n == sess.depth_for_samples(4 * cfg.batch_size),
          f"interleaved plan: {n} grouped launches")
    agree("interleaved ShardingPlan vs plan=none, 4 queries", got,
          none.serve_direct(big["dense"], big["indices"]))
    del sess
    peak_line("phase 4b (interleaved ShardingPlan)")


# ---------------------------------------------------------------- phase 5
def library_pairs(bot, pooled, li, lj):
    """torch.bmm + the tril gather: the interaction's library yardstick,
    timed here and never called by the port."""
    a = torch.cat([bot[:, None, :], pooled], dim=1).float()
    f = torch.bmm(a, a.transpose(1, 2))
    return torch.cat([bot.float(), f[:, li, lj]], dim=1)


def library_version(tables, ids, bot, li, lj):
    """F.embedding_bag(mode="sum") + the interaction's yardstick."""
    return library_pairs(bot, library_bag(tables, ids), li, lj)


def library_bag(tables, ids):
    """One F.embedding_bag(mode="sum") call over the flattened tables."""
    T, R, d = tables.shape
    B, _, L = ids.shape
    t = torch.arange(T, device=ids.device)[None, :, None] * R
    flat = (ids.long() + t).view(B * T, L)
    return torch.nn.functional.embedding_bag(
        flat, tables.view(T * R, d), mode="sum").view(B, T, d)


def library_grouped(tf, tb, ids, bot, inv, li, lj):
    """Per-group F.embedding_bag, cat, index_select(inv_perm), bmm and the
    tril gather: the grouped kernel's library yardstick."""
    n = tf.shape[0]
    pooled = torch.cat([library_bag(tf, ids[:, :n]),
                        library_bag(tb, ids[:, n:])], dim=1)
    return library_pairs(bot, pooled.index_select(1, inv), li, lj)


def distinct_rows(ids, rows_per_table):
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


def bound(tables, ids, bot):
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


def time_ms(fn, n_sets, iters=40):
    for k in range(n_sets):
        fn(k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, n_sets, iters=40):
    """(CUDA-event ms a call as ``time_ms`` takes it, device ms a call):
    the second is the sum of the kernels' own times under torch.profiler
    over ``iters`` calls, so it leaves out the host time between launches,
    which the first includes where a call is shorter than its launch. The
    profiler now and then records no kernel of a short run; it is asked
    three times, and the device time is None if it never sees one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    event = time_ms(fn, n_sets, iters)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i % n_sets)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return event, busy / iters / 1e3
    return event, None


def report_time(name, shape, k_times, p_ms, l_ms, bounds):
    """Print and return one kernel's times (``kernel_ms``) beside the mean
    of its bounds over the input sets (``least_time`` tuples). ``p_ms`` and
    ``l_ms`` may be None where a shape is too large for the plain or
    library version."""
    k_ms, d_ms = k_times
    b_ms = float(np.mean([b[0] for b in bounds]))
    dev, per = ("not measured", k_ms) if d_ms is None else (
        f"{d_ms:.4f} ms", d_ms)
    nbytes = float(np.mean([b[2] for b in bounds]))
    flops = float(np.mean([b[3] for b in bounds]))
    plain = "not run" if p_ms is None else f"{p_ms:.4f} ms"
    library = "not run" if l_ms is None else f"{l_ms:.4f} ms"
    print(f"[time] {name} {shape}: kernel {k_ms:.4f} ms (device {dev}), "
          f"bound {b_ms:.4f} ms ({bounds[0][1]}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP; {b_ms / per:.1%} of the "
          f"{'kernel' if d_ms is None else 'device'} time), plain {plain}, "
          f"library {library}; rate {nbytes / per / 1e9:.3f} TB/s, "
          f"{flops / per / 1e9:.3f} TFLOP/s")
    return dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=b_ms, bound_by=bounds[0][1], shape=shape)


BATCHES = (25, 100, 200, 800)


def phase_timing(none, auto, dev):
    """Both serve kernels at the main path's shapes: B=25 and 100 are the
    micro-batches of a 1- and a 4-query flush at the planner's depth 8,
    B=200 and 800 the whole query and capacity batch. 8 input sets in
    turn: 8 x 82 MB of rows at B=200 overflow the 50 MB L2, so each
    launch finds its rows cold, as a new query does."""
    from repro_torch.kernels import fused_serve, ref
    from repro_torch.parallel import plan_table_groups
    tables = none.params["tables"]
    tf, tb = auto.params["tables_fast"], auto.params["tables_bulk"]
    groups = plan_table_groups(auto.plan, 1)
    inv = torch.as_tensor(groups.inv_perm, device=dev)
    perm = torch.as_tensor(groups.fast_ids + groups.bulk_ids, device=dev)
    pos = fused_serve.grouped_pos(groups.inv_perm, dev)
    T, R, d = tables.shape
    L = none.cfg.lookups_per_table
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    rows = {"fused_bag_interactions": {},
            "fused_grouped_bag_interactions": {}}
    for B in BATCHES:
        sets = [draw_case(B, T, L, d, R, tables.dtype, gen, dev, tables)[1:]
                for _ in range(8)]
        gsets = [(ids.index_select(1, perm), bot) for ids, bot in sets]
        shape = f"B={B} T={T} L={L} d={d} R={R} fp32"
        want = ref.fused_bag_interactions_ref(tables, *sets[0])
        check(torch.allclose(library_version(tables, *sets[0], li, lj), want,
                             rtol=RTOL, atol=ATOL),
              "library yardstick disagrees with the plain version")
        check(torch.allclose(library_grouped(tf, tb, *gsets[0], inv, li, lj),
                             want, rtol=RTOL, atol=ATOL),
              "grouped library yardstick disagrees with the plain version")
        rows["fused_bag_interactions"][B] = report_time(
            "fused_bag_interactions", shape,
            kernel_ms(lambda k: fused_serve.fused_bag_interactions(
                tables, *sets[k]), len(sets)),
            time_ms(lambda k: ref.fused_bag_interactions_ref(
                tables, *sets[k]), len(sets), iters=16),
            time_ms(lambda k: library_version(tables, *sets[k], li, lj),
                    len(sets), iters=16),
            [bound(tables, *s) for s in sets])
        rows["fused_grouped_bag_interactions"][B] = report_time(
            "fused_grouped_bag_interactions",
            f"B={B} Tf={tf.shape[0]} Tb={tb.shape[0]} L={L} d={d} R={R} "
            f"fp32",
            kernel_ms(lambda k: fused_serve.fused_grouped_bag_interactions(
                tf, tb, *gsets[k], pos), len(gsets)),
            time_ms(lambda k: ref.fused_grouped_bag_interactions_ref(
                tf, tb, *gsets[k], groups.inv_perm), len(gsets), iters=16),
            time_ms(lambda k: library_grouped(tf, tb, *gsets[k], inv, li,
                                              lj), len(gsets), iters=16),
            [bound(tf, *s) for s in gsets])
    peak_line("phase 5 (serve kernel timing)")
    return rows


def profile_flushes(sess, label, table=False, n=5):
    """torch.profiler over capacity flushes: device time by kernel, and
    the share of the flush's service time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    qs = submit_queries(sess.cfg)
    sess._execute(qs)
    service = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            service += sess._execute(qs)[1]
    events = prof.key_averages()
    if table:
        print(events.table(sort_by="cuda_time_total", row_limit=15))
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    flush = service / n * 1e3
    print(f"[profile] {label}: capacity flush (800 samples, depth "
          f"{sess.depth_for_samples(800)}) service {flush:.4f} ms, device "
          f"busy {busy:.4f} ms ({busy / flush:.0%}), idle "
          f"{max(flush - busy, 0.0):.4f} ms")
    for e in kernels[:5]:
        print(f"[profile]   {e.self_device_time_total / n / 1e3:.4f} ms a "
              f"flush, {e.count // n} launches: {e.key[:80]}")


# ---------------------------------------------------------------- phase 6
def tiered_stream(cfg, dev):
    """The 4 batches of the alpha = 1.05 stream that phase 6 looks up, and
    uniform ids of the same shape."""
    from repro_torch.data.recsys import make_recsys_batch
    stream = [make_recsys_batch(cfg, 10 + s, 0, TIERED_ALPHA)["indices"]
              for s in range(4)]
    uniform = torch.randint(0, cfg.rows_per_table, stream[0].shape,
                            device=dev, dtype=torch.int32,
                            generator=torch.Generator(device=dev)
                            .manual_seed(7))
    return stream, uniform


def phase_tiered(tables, cfg, dev):
    """Phase 6a: the tiered runtime at full width on the plan=none
    session's weights, through the cached-bag kernel. The other serve
    sessions are gone; the store is returned for phases 7a and 6b."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.kernels import embedding_bags, ops, ref

    R = tables.shape[1]
    t0 = time.perf_counter()
    counts = te.measure_row_freq(cfg, TIERED_ALPHA, seed=0, n_batches=4,
                                 device=dev)
    store = te.build_tiered_tables(tables, counts, HOT_PER_TABLE)
    torch.cuda.synchronize()
    print(f"[tiered] store built in {time.perf_counter() - t0:.2f} s: fast "
          f"{tuple(store.fast.shape)}, bulk {tuple(store.bulk.shape)}, "
          f"row_map {tuple(store.row_map.shape)}; expected hit ratio "
          f"{te.expected_hit_ratio(counts, store):.4f}")
    check(torch.equal(store.bulk[:, :R], tables),
          "the bulk tier does not hold the tables")
    stream, uniform = tiered_stream(cfg, dev)
    hits = float(torch.stack([te.hit_mask(store, i) for i in stream])
                 .float().mean())
    print(f"[tiered] measured hit ratio on 4 batches of the alpha="
          f"{TIERED_ALPHA} stream: {hits:.4f}")
    wants = [ref.embedding_bag_ref(tables, i) for i in stream]
    errs = {}
    ops.reset_launch_counts()
    pools = [te.tiered_embedding_bag(store, i) for i in stream]
    launches = {"cached_embedding_bag":
                ops.launch_counts["cached_embedding_bag"]}
    for k, (got, want) in enumerate(zip(pools, wants)):
        close("tiered_embedding_bag", f"batch {k} vs embedding_bag_ref",
              got, want, errs)
    check(launches["cached_embedding_bag"] == 4,
          f"{launches} cached-bag launches for 4 batches")
    for tag, ids in ((f"alpha={TIERED_ALPHA}", stream[0]),
                     ("uniform", uniform)):
        fi, bi = te.translate_indices(store, ids)
        close("cached_embedding_bag", f"B=200 {tag} ids, S={HOT_PER_TABLE}",
              embedding_bags.cached_embedding_bag(store.fast, store.bulk, fi,
                                                  bi),
              ref.cached_embedding_bag_ref(store.fast, store.bulk, fi, bi),
              errs)
    sets = [te.translate_indices(store, make_recsys_batch(
        cfg, 100 + s, 0, TIERED_ALPHA)["indices"]) for s in range(8)]
    times = {"cached_embedding_bag": time_b6(store, sets)}
    peak_line("phase 6a (tiered store, cached bag)")
    return store, (launches, times, {k: max(v) for k, v in errs.items()})


def phase_packed(store, cfg, dev):
    """Phase 6b: the store packed into one array a table, looked up
    through the embedding-bag kernel; the stacked tables are gone."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.kernels import embedding_bags, ops, ref

    R = cfg.rows_per_table
    stream, uniform = tiered_stream(cfg, dev)
    errs = {}
    packed = te.packed_tables(store)
    bulk_view = store.bulk[:, :R]
    ops.reset_launch_counts()
    pools = [te.tiered_embedding_bag_packed(packed, store, i) for i in stream]
    launches = {"embedding_bag": ops.launch_counts["embedding_bag"]}
    for k, (got, ids) in enumerate(zip(pools, stream)):
        close("tiered_embedding_bag_packed",
              f"batch {k} vs embedding_bag_ref", got,
              ref.embedding_bag_ref(bulk_view, ids), errs)
    check(launches["embedding_bag"] == 4,
          f"{launches} embedding-bag launches for 4 batches")
    for tag, ids in ((f"alpha={TIERED_ALPHA}", stream[0]),
                     ("uniform", uniform)):
        phys = te.translate_indices_packed(store, ids)
        close("embedding_bag", f"B=200 {tag} ids on the packed store",
              embedding_bags.embedding_bag(packed, phys),
              ref.embedding_bag_ref(packed, phys), errs)
    psets = [te.translate_indices_packed(store, make_recsys_batch(
        cfg, 100 + s, 0, TIERED_ALPHA)["indices"]) for s in range(8)]
    times = {"embedding_bag": time_b4(packed, psets)}
    print(f"[tiered] launches {launches} (4 batches)")
    peak_line("phase 6b (packed store, embedding bag)")
    return launches, times, {k: max(v) for k, v in errs.items()}


def time_b6(store, sets):
    from repro_torch.kernels import embedding_bags, ref
    fast, bulk = store.fast, store.bulk
    B, T, L = sets[0][0].shape
    d = fast.shape[2]
    want = ref.cached_embedding_bag_ref(fast, bulk, *sets[0])
    check(torch.allclose(library_bag(fast, sets[0][0])
                         + library_bag(bulk, sets[0][1]), want, rtol=RTOL,
                         atol=ATOL),
          "cached-bag library yardstick disagrees with the plain version")
    bounds = []
    for fi, bi in sets:
        rows = distinct_rows(fi, fast.shape[1]) + distinct_rows(
            bi, bulk.shape[1])
        nbytes = (rows * d * fast.element_size() + 2 * fi.numel() * 4
                  + B * T * d * 4)
        bounds.append(least_time(nbytes, 2 * B * T * L * d))
    return report_time(
        "cached_embedding_bag",
        f"B={B} T={T} L={L} d={d} S+1={fast.shape[1]} R+1={bulk.shape[1]} "
        f"fp32, alpha={TIERED_ALPHA} stream",
        kernel_ms(lambda k: embedding_bags.cached_embedding_bag(
            fast, bulk, *sets[k]), len(sets)),
        time_ms(lambda k: ref.cached_embedding_bag_ref(fast, bulk, *sets[k]),
                len(sets), iters=16),
        time_ms(lambda k: library_bag(fast, sets[k][0])
                + library_bag(bulk, sets[k][1]), len(sets), iters=16),
        bounds)


def time_b4(packed, sets):
    from repro_torch.kernels import embedding_bags, ref
    B, T, L = sets[0].shape
    d = packed.shape[2]
    check(torch.allclose(library_bag(packed, sets[0]),
                         ref.embedding_bag_ref(packed, sets[0]), rtol=RTOL,
                         atol=ATOL),
          "embedding-bag library yardstick disagrees with the plain version")
    bounds = []
    for ids in sets:
        nbytes = (distinct_rows(ids, packed.shape[1]) * d
                  * packed.element_size() + ids.numel() * 4 + B * T * d * 4)
        bounds.append(least_time(nbytes, B * T * L * d))
    return report_time(
        "embedding_bag",
        f"B={B} T={T} L={L} d={d} rows={packed.shape[1]} (packed store) "
        f"fp32, alpha={TIERED_ALPHA} stream",
        kernel_ms(lambda k: embedding_bags.embedding_bag(packed, sets[k]),
                len(sets)),
        time_ms(lambda k: ref.embedding_bag_ref(packed, sets[k]), len(sets),
                iters=16),
        time_ms(lambda k: library_bag(packed, sets[k]), len(sets), iters=16),
        bounds)


# ---------------------------------------------------------------- phase 7
def serve_batches(cfg, first, n):
    """n batches of the alpha = 1.05 stream, 200 samples each, then the
    main path's shapes cut from them: B = 25, 100, 200 from one batch, 800
    from four."""
    from repro_torch.data.recsys import make_recsys_batch
    return [make_recsys_batch(cfg, first + s, 0, TIERED_ALPHA)["indices"]
            for s in range(n)]


def cut(batches, B, k):
    """Input set k of batch size B: a slice of batch k, or four batches."""
    if B <= batches[0].shape[0]:
        return batches[k % len(batches)][:B]
    n = B // batches[0].shape[0]
    return torch.cat([batches[(n * k + j) % len(batches)] for j in range(n)])


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


def draw_store(T, S, R, d, dtype, gen, dev):
    """A small two-tier store whose pad slots (S, R) are not zero, so a
    kernel that skipped them would differ from the plain version."""
    fast = torch.empty((T, S + 1, d), device=dev).uniform_(-1, 1,
                                                           generator=gen)
    bulk = torch.empty((T, R + 1, d), device=dev).uniform_(-1, 1,
                                                           generator=gen)
    fast[:, S], bulk[:, R] = 0.5, 0.5
    return fast.to(dtype), bulk.to(dtype)


def phase_api_serve(tables, store, cfg, dev):
    """Phase 7a: the two-tier fused op (row 2) and the interaction op (row
    7) on phase 6's store and the stacked tables it was built from."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.kernels import (embedding_bags, feature_interactions,
                                     fused_serve, ops, ref)
    interactions_kernel = feature_interactions.interactions

    t0 = time.perf_counter()
    T, R, d = tables.shape
    gen = torch.Generator(device=dev).manual_seed(77)
    batches = serve_batches(cfg, 20, 4)
    ids = {B: cut(batches, B, 0) for B in BATCHES}
    tiers = {B: te.translate_indices(store, i) for B, i in ids.items()}
    bots = {B: torch.empty((B, d), device=dev).uniform_(-1, 1, generator=gen)
            for B in BATCHES}
    errs = {}
    ops.reset_launch_counts()
    got2 = {B: ops.fused_cached_bag_interactions(store.fast, store.bulk,
                                                 *tiers[B], bots[B])
            for B in BATCHES}
    pooled = {B: ops.embedding_bag(tables, ids[B]) for B in BATCHES}
    got7 = {B: ops.interactions(bots[B], pooled[B]) for B in BATCHES}
    launches = {k: ops.launch_counts[k]
                for k in ("fused_cached_bag_interactions", "interactions")}
    print(f"[api] launches {launches} (4 batch sizes each)")
    check(launches == {k: len(BATCHES) for k in launches},
          f"{launches}: not one launch a batch size")
    for B in BATCHES:
        shape = f"B={B} T={T} L={ids[B].shape[2]} d={d} S+1=" \
                f"{store.fast.shape[1]} R+1={store.bulk.shape[1]} fp32"
        close("fused_cached_bag_interactions", f"{shape} vs plain", got2[B],
              ref.fused_cached_bag_interactions_ref(
                  store.fast, store.bulk, *tiers[B], bots[B]), errs,
              pairs=(T, d))
        close("fused_cached_bag_interactions",
              f"B={B} vs fused_bag_interactions on the stacked tables",
              got2[B], fused_serve.fused_bag_interactions(tables, ids[B],
                                                          bots[B]),
              errs, pairs=(T, d))
        close("interactions", f"B={B} T={T} d={d} fp32 pooled of the batch",
              got7[B], ref.interactions_ref(bots[B], pooled[B]), errs,
              pairs=(T, d))
        half = pooled[B].bfloat16()
        close("interactions", f"B={B} T={T} d={d} bf16 pooled",
              interactions_kernel(bots[B], half),
              ref.interactions_ref(bots[B], half), errs, pairs=(T, d))
    del got2, got7

    # RM2-large's width, d = 128: rows cut to 262,144 a table for memory,
    # at the model's init scale, looked up with the same batches' ids
    R128 = 262_144
    wide = torch.empty((T, R128, 128), device=dev).uniform_(
        -R ** -0.5, R ** -0.5, generator=gen)
    for B in BATCHES:
        pooled128 = embedding_bags.embedding_bag(wide, ids[B] % R128)
        bot128 = torch.empty((B, 128), device=dev).uniform_(-1, 1,
                                                            generator=gen)
        for p in (pooled128, pooled128.bfloat16()):
            close("interactions", f"B={B} T={T} d=128 {p.dtype}",
                  interactions_kernel(bot128, p),
                  ref.interactions_ref(bot128, p), errs, pairs=(T, 128))
    del wide, pooled128
    for B, Tn, dn in ((1, 1, 8), (3, 2, 32), (16, 100, 128)):
        x = torch.randn((B, Tn, dn), device=dev, generator=gen)
        bot = torch.randn((B, dn), device=dev, generator=gen)
        for bdt in (torch.float32, torch.bfloat16):
            close("interactions", f"B={B} T={Tn} d={dn} bot_out {bdt}",
                  interactions_kernel(bot.to(bdt), x),
                  ref.interactions_ref(bot.to(bdt), x), errs,
                  pairs=(Tn, dn))

    # the store in bf16, at the query's B = 200
    B = BATCHES[2]
    fast16, bulk16 = store.fast.bfloat16(), store.bulk.bfloat16()
    close("fused_cached_bag_interactions", f"B={B} bf16 store",
          fused_serve.fused_cached_bag_interactions(fast16, bulk16,
                                                    *tiers[B], bots[B]),
          ref.fused_cached_bag_interactions_ref(fast16, bulk16, *tiers[B],
                                                bots[B]),
          errs, pairs=(T, d))
    del fast16, bulk16
    torch.cuda.empty_cache()
    # edge shapes: d = 128 and 256, non-zero pad rows read and summed, 52 KB
    # of shared memory at T = 100, ids outside a tier read as NaN
    for B, Tn, L, dn, S, Rn in ((16, 8, 4, 128, 9, 50), (8, 4, 8, 256, 5, 64),
                                (4, 100, 2, 128, 3, 20), (37, 3, 5, 32, 4,
                                                          1000)):
        for dtype in (torch.float32, torch.bfloat16):
            fast, bulk = draw_store(Tn, S, Rn, dn, dtype, gen, dev)
            fi = torch.randint(0, S + 1, (B, Tn, L), generator=gen,
                               device=dev, dtype=torch.int32)
            bi = torch.randint(0, Rn + 1, (B, Tn, L), generator=gen,
                               device=dev, dtype=torch.int32)
            bot = torch.empty((B, dn), device=dev).uniform_(-1, 1,
                                                            generator=gen)
            close("fused_cached_bag_interactions",
                  f"B={B} T={Tn} L={L} d={dn} S={S} R={Rn} pad rows 0.5 "
                  f"{dtype}",
                  fused_serve.fused_cached_bag_interactions(fast, bulk, fi,
                                                            bi, bot),
                  ref.fused_cached_bag_interactions_ref(fast, bulk, fi, bi,
                                                        bot),
                  errs, pairs=(Tn, dn))
    fi[0, 0, 0], bi[1, 1, 1], bi[2, 2, 2] = -1, Rn + 1, -(Rn + 2)
    close("fused_cached_bag_interactions",
          "out-of-range ids read as jnp.take does",
          fused_serve.fused_cached_bag_interactions(fast, bulk, fi, bi, bot),
          ref.fused_cached_bag_interactions_ref(fast, bulk, fi, bi, bot),
          errs, nan_ok=True, pairs=(Tn, dn))
    times = time_api_serve(tables, store, cfg, dev)
    peak_line(f"phase 7a (kernels API: two-tier fused op, interaction; "
              f"{time.perf_counter() - t0:.1f} s)")
    return launches, times, {k: max(v) for k, v in errs.items()}


def time_api_serve(tables, store, cfg, dev):
    """Rows 2 and 7 at the main path's batch sizes, 8 input sets in turn
    (at B >= 200 their rows overflow the 50 MB L2)."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.kernels import (embedding_bags, feature_interactions,
                                     fused_serve, ref)
    interactions_kernel = feature_interactions.interactions
    T, _, d = tables.shape
    fast, bulk = store.fast, store.bulk
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(78)
    batches = serve_batches(cfg, 200, 16)
    rows = {"fused_cached_bag_interactions": {}, "interactions": {}}
    for B in BATCHES:
        sets = []
        for k in range(8):
            fi, bi = te.translate_indices(store, cut(batches, B, k))
            bot = torch.empty((B, d), device=dev).uniform_(-1, 1,
                                                           generator=gen)
            sets.append((fi, bi, bot))
        want = ref.fused_cached_bag_interactions_ref(fast, bulk, *sets[0])
        check(torch.allclose(library_pairs(
            sets[0][2], library_bag(fast, sets[0][0])
            + library_bag(bulk, sets[0][1]), li, lj), want, rtol=RTOL,
            atol=ATOL),
            "two-tier library yardstick disagrees with the plain version")
        shape = f"B={B} T={T} L={sets[0][0].shape[2]} d={d} " \
                f"S+1={fast.shape[1]} R+1={bulk.shape[1]} fp32, " \
                f"alpha={TIERED_ALPHA} stream"
        rows["fused_cached_bag_interactions"][B] = report_time(
            "fused_cached_bag_interactions", shape,
            kernel_ms(lambda k: fused_serve.fused_cached_bag_interactions(
                fast, bulk, *sets[k]), len(sets)),
            time_ms(lambda k: ref.fused_cached_bag_interactions_ref(
                fast, bulk, *sets[k]), len(sets), iters=16),
            time_ms(lambda k: library_pairs(
                sets[k][2], library_bag(fast, sets[k][0])
                + library_bag(bulk, sets[k][1]), li, lj), len(sets),
                iters=16),
            [cached_pairs_bound(fast, bulk, *s) for s in sets])
        psets = [(s[2], embedding_bags.embedding_bag(tables, cut(batches, B,
                                                                 k)))
                 for k, s in enumerate(sets)]
        check(torch.allclose(library_pairs(*psets[0], li, lj),
                             ref.interactions_ref(*psets[0]), rtol=RTOL,
                             atol=ATOL),
              "interaction library yardstick disagrees with the plain "
              "version")
        rows["interactions"][B] = report_time(
            "interactions", f"B={B} T={T} d={d} fp32 pooled",
            kernel_ms(lambda k: interactions_kernel(*psets[k]), len(psets)),
            time_ms(lambda k: ref.interactions_ref(*psets[k]), len(psets),
                    iters=16),
            time_ms(lambda k: library_pairs(*psets[k], li, lj), len(psets),
                    iters=16),
            [pairs_bound(*p) for p in psets])
    return rows


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


def close_attention(kernel, name, got, want, errs):
    """Hold an attention output against its plain version: same shape and
    dtype, finite, allclose at the tests' tolerance for the dtype, and each
    row (the last dim) within ATTN_ROW_TOL of its own norm."""
    torch.cuda.synchronize()
    tol, row_tol = ATTN_TOL[want.dtype], ATTN_ROW_TOL[want.dtype]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kernel} {name}: {tuple(got.shape)} {got.dtype}, want "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{kernel} {name}: not finite")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    ok = bool(torch.allclose(g, w, rtol=tol, atol=tol))
    hd = w.shape[-1]
    scaled = ((g - w).reshape(-1, hd).norm(dim=1)
              / w.reshape(-1, hd).norm(dim=1).clamp_min(1e-30)).max().item()
    ok_rows = scaled <= row_tol
    print(f"[kernel] {kernel} {name}: max_abs_err={err:.3e} (tol {tol}) "
          f"row err/scale={scaled:.3e} (limit {row_tol}) "
          f"{'ok' if ok and ok_rows else 'OVER TOLERANCE'}")
    check(ok, f"{kernel} {name}: kernel disagrees with its plain version")
    check(ok_rows, f"{kernel} {name}: a row is off by {scaled:.3e} of its "
                   f"norm (limit {row_tol})")
    record(errs, kernel, err, scaled)


def attention_inputs(B, T, S, Hq, Hkv, hd, dtype, gen, dev):
    return (torch.randn((B, T, Hq, hd), device=dev, generator=gen).to(dtype),
            torch.randn((B, S, Hkv, hd), device=dev, generator=gen).to(dtype),
            torch.randn((B, S, Hkv, hd), device=dev, generator=gen).to(dtype))


def sdpa_attention(q, k, v, causal, window):
    """F.scaled_dot_product_attention with enable_gqa and a boolean mask:
    the library yardstick, timed here and never called by the port."""
    T, S = q.shape[1], k.shape[1]
    t = torch.arange(T, device=q.device)[:, None]
    s = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= s <= t
    if window is not None:
        ok &= t - s < window
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=ok, enable_gqa=True).transpose(1, 2)


def sdpa_decode(q, k_cache, v_cache, lengths):
    """The decode yardstick: one query token, the lengths as a mask."""
    S = k_cache.shape[1]
    ok = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k_cache.transpose(1, 2), v_cache.transpose(1, 2),
        attn_mask=ok[:, None, None], enable_gqa=True)[:, :, 0]


def rows_by_hand(q, k, v, rows, window):
    """Causal windowed attention of a few (b, t, h) rows, computed alone in
    fp32: the check of the prefill_32k output, too large for the plain
    version."""
    hd = q.shape[3]
    G = q.shape[2] // k.shape[2]
    out = []
    for b, t, h in rows:
        lo = max(0, t - window + 1)
        kk = k[b, lo:t + 1, h // G].float()
        s = kk @ q[b, t, h].float() / math.sqrt(hd)
        out.append(torch.softmax(s, 0) @ v[b, lo:t + 1, h // G].float())
    return torch.stack(out)


def phase_api_attention(dev):
    """Phase 7b: flash attention (row 8) and flash decode (row 9) at
    mixtral-8x7b's widths, alone on the card."""
    from repro_torch.kernels import attention, ops, ref
    attention_kernel, decode_kernel = (attention.flash_attention,
                                       attention.flash_decode)
    Hq, Hkv, hd, win = (MIXTRAL[k] for k in ("Hq", "Hkv", "hd", "window"))
    gen = torch.Generator(device=dev).manual_seed(2024)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    errs = {}
    q, k, v = attention_inputs(1, PREFILL_T, PREFILL_T, Hq, Hkv, hd,
                               torch.bfloat16, gen, dev)
    kc, vc = (torch.randn((DECODE_B, DECODE_S, Hkv, hd), device=dev,
                          generator=gen).bfloat16() for _ in range(2))
    dq = torch.randn((DECODE_B, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = torch.randint(1, DECODE_S + 1, (DECODE_B,), generator=gen,
                         device=dev)
    ops.reset_launch_counts()
    prefill = ops.flash_attention(q, k, v, causal=True, window=win)
    decode = ops.flash_decode(dq, kc, vc, lens)
    launches = {n: ops.launch_counts[n]
                for n in ("flash_attention", "flash_decode")}
    print(f"[api] launches {launches} (prefill_32k, decode_32k)")
    check(launches == {"flash_attention": 1, "flash_decode": 1},
          f"{launches}: not one launch each")
    T = PREFILL_T
    # the window's edges, then 52 rows drawn from its interior (t >= win,
    # where each row weighs a full window of keys)
    rows = [(0, t, h) for t in (0, 1, win - 1, win, T // 2 + 3, T - 1)
            for h in (0, Hq - 1)]
    rows += [(0, int(t), int(h)) for t, h in zip(
        torch.randint(win, T, (52,), generator=gen, device=dev).tolist(),
        torch.randint(0, Hq, (52,), generator=gen, device=dev).tolist())]
    close_attention("flash_attention", f"T=S={T} {len(rows)} sampled rows "
                    f"by hand",
                    torch.stack([prefill[b, t, h] for b, t, h in rows]),
                    rows_by_hand(q, k, v, rows, win).bfloat16(), errs)
    picks = (0, DECODE_B // 2, DECODE_B - 1)
    close_attention("flash_decode", f"B={DECODE_B} S={DECODE_S} samples "
                    f"{picks} vs plain", decode[list(picks)],
                    torch.cat([ref.flash_decode_ref(
                        dq[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                        lens[b:b + 1]) for b in picks]), errs)
    times = {"flash_attention": {}, "flash_decode": {}}
    times["flash_attention"][PREFILL_T] = report_time(
        "flash_attention", f"B=1 T=S={T} Hq={Hq} Hkv={Hkv} hd={hd} causal "
        f"window={win} bf16 (prefill_32k, batch cut from 32)",
        kernel_ms(lambda _: attention_kernel(q, k, v, causal=True, window=win),
                1, iters=3), None, None,
        [attention_bound(q, k, True, win)])
    times["flash_decode"][DECODE_B] = report_time(
        "flash_decode", f"B={DECODE_B} S={DECODE_S} Hq={Hq} Hkv={Hkv} "
        f"hd={hd} bf16, lengths in [1, S] (decode_32k)",
        kernel_ms(lambda _: decode_kernel(dq, kc, vc, lens), 1, iters=10),
        None, None, [decode_bound(dq, kc, lens)])
    del q, k, v, prefill, kc, vc, dq, decode
    torch.cuda.empty_cache()
    peak_line("phase 7b (kernels API: attention at prefill_32k, "
              "decode_32k)")

    # T = S = CHECK_T: kernel, plain version and library, mixtral's widths
    T = CHECK_T
    q, k, v = attention_inputs(1, T, T, Hq, Hkv, hd, torch.bfloat16, gen,
                               dev)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
    close_attention("flash_attention", f"B=1 T=S={T} mixtral bf16",
                    attention_kernel(q, k, v, causal=True, window=win), want,
                    errs)
    lib = sdpa_attention(q, k, v, True, win)
    check(torch.allclose(lib.float(), want.float(), rtol=3e-2, atol=3e-2),
          "attention library yardstick disagrees with the plain version")
    del want, lib
    torch.cuda.empty_cache()
    shape = f"B=1 T=S={T} Hq={Hq} Hkv={Hkv} hd={hd} causal window={win} bf16"
    times["flash_attention"][T] = report_time(
        "flash_attention", shape,
        kernel_ms(lambda _: attention_kernel(q, k, v, causal=True, window=win),
                1, iters=10),
        time_ms(lambda _: ref.flash_attention_ref(q, k, v, causal=True,
                                                  window=win), 1, iters=3),
        time_ms(lambda _: sdpa_attention(q, k, v, True, win), 1, iters=3),
        [attention_bound(q, k, True, win)])
    del q, k, v
    torch.cuda.empty_cache()
    # edge cases: hd = 120 (h2o-danube-3-4b), internlm2-1.8b's 16/8 heads
    # without a window, non-causal with and without a window, T not a
    # multiple of the 64-row tile, T != S (fully masked rows when T > S
    # with a window), fp32 inputs (the CUDA-core path), a window of 1,
    # B = 2, bf16 at hd = 36 (not a multiple of 8: the CUDA-core path)
    for B, T, S, hq, hkv, d, causal, w, dtype in (
            (1, 1000, 1000, 32, 8, 120, True, 256, torch.bfloat16),
            (1, 1000, 1000, 32, 8, 120, True, 256, torch.float32),
            (1, 2048, 2048, 16, 8, 128, True, None, torch.bfloat16),
            (2, 512, 512, 32, 8, 128, False, None, torch.bfloat16),
            (1, 700, 700, 32, 8, 128, False, 100, torch.bfloat16),
            (1, 300, 1000, 32, 8, 128, True, 128, torch.bfloat16),
            (1, 1000, 300, 32, 8, 128, True, 64, torch.bfloat16),
            (1, 1000, 300, 8, 2, 64, False, 64, torch.float32),
            (1, 1024, 1024, 32, 8, 128, True, 256, torch.float32),
            (1, 130, 130, 4, 1, 32, True, 1, torch.float32),
            (2, 77, 200, 6, 3, 16, False, None, torch.float32),
            (1, 100, 100, 4, 2, 36, True, 16, torch.bfloat16)):
        q, k, v = attention_inputs(B, T, S, hq, hkv, d, dtype, gen, dev)
        close_attention(
            "flash_attention", f"B={B} T={T} S={S} Hq={hq} Hkv={hkv} hd={d} "
            f"causal={causal} window={w} {str(dtype)[6:]}",
            attention_kernel(q, k, v, causal=causal, window=w),
            ref.flash_attention_ref(q, k, v, causal=causal, window=w), errs)
    # bf16 q not 16-byte aligned (a view 2 bytes into its storage): the
    # fp32 path takes it, as it takes hd = 36 above
    buf = torch.randn((1 + 300 * 8 * 64,), device=dev, generator=gen)
    q = buf.bfloat16()[1:].view(1, 300, 8, 64)
    _, k, v = attention_inputs(1, 300, 300, 8, 2, 64, torch.bfloat16, gen, dev)
    close_attention("flash_attention", "bf16 q 2 bytes off 16-byte alignment",
                    attention_kernel(q, k, v, causal=True, window=64),
                    ref.flash_attention_ref(q, k, v, causal=True, window=64),
                    errs)

    # decode: B = 8 against the plain version (lengths 0, S and above S
    # among them), a poisoned tail, and TIME_DECODE_B caches for the timing
    # beside the plain version and the library
    S = DECODE_S
    kc, vc = (torch.randn((8, S, Hkv, hd), device=dev, generator=gen)
              .bfloat16() for _ in range(2))
    dq = torch.randn((8, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = torch.randint(1, S + 1, (8,), generator=gen, device=dev)
    lens[0], lens[1], lens[2] = 0, S, S + 100
    got = decode_kernel(dq, kc, vc, lens)
    close_attention("flash_decode", f"B=8 S={S} mixtral bf16 lengths "
                    f"{lens.tolist()}", got,
                    ref.flash_decode_ref(dq, kc, vc, lens), errs)
    n = int(lens[3])
    kc[3, n:], vc[3, n:] = 1e9, -1e9
    poisoned = decode_kernel(dq, kc, vc, lens)
    torch.cuda.synchronize()
    check(torch.equal(poisoned, got), "flash_decode read past a length")
    close_attention("flash_decode", f"B=8 poisoned tail past length {n}",
                    poisoned, ref.flash_decode_ref(dq, kc, vc, lens), errs)
    del kc, vc
    for B, S, hq, hkv, d, dtype in ((4, 3000, 32, 8, 120, torch.bfloat16),
                                    (4, 3000, 16, 8, 128, torch.bfloat16),
                                    (3, 2000, 32, 4, 128, torch.float32),
                                    (5, 77, 8, 8, 64, torch.float32),
                                    (2, 100, 4, 1, 16, torch.float32)):
        kc, vc = (torch.randn((B, S, hkv, d), device=dev, generator=gen)
                  .to(dtype) for _ in range(2))
        dq = torch.randn((B, hq, d), device=dev, generator=gen).to(dtype)
        lens = torch.randint(0, S + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        close_attention("flash_decode", f"B={B} S={S} Hq={hq} Hkv={hkv} "
                        f"hd={d} {str(dtype)[6:]} int32 lengths "
                        f"{lens.tolist()}", decode_kernel(dq, kc, vc, lens),
                        ref.flash_decode_ref(dq, kc, vc, lens), errs)
    B, S = TIME_DECODE_B, DECODE_S
    kc, vc = (torch.randn((B, S, Hkv, hd), device=dev, generator=gen)
              .bfloat16() for _ in range(2))
    dq = torch.randn((B, Hq, hd), device=dev, generator=gen).bfloat16()
    lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    want = ref.flash_decode_ref(dq, kc, vc, lens)
    close_attention("flash_decode", f"B={B} S={S} mixtral bf16", decode_kernel(
        dq, kc, vc, lens), want, errs)
    check(torch.allclose(sdpa_decode(dq, kc, vc, lens).float(), want.float(),
                         rtol=3e-2, atol=3e-2),
          "decode library yardstick disagrees with the plain version")
    times["flash_decode"][B] = report_time(
        "flash_decode", f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} bf16, "
        f"lengths in [1, S]",
        kernel_ms(lambda _: decode_kernel(dq, kc, vc, lens), 1, iters=20),
        time_ms(lambda _: ref.flash_decode_ref(dq, kc, vc, lens), 1,
                iters=3),
        time_ms(lambda _: sdpa_decode(dq, kc, vc, lens), 1, iters=3),
        [decode_bound(dq, kc, lens)])
    peak_line(f"phase 7b (kernels API: attention checks and timing; "
              f"{time.perf_counter() - t0:.1f} s in all)")
    return launches, times, {k: max(v) for k, v in errs.items()}


def build_all():
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import (_build, attention, embedding_bags,
                                     feature_interactions, fused_serve)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(_build.build, (
            "fused_serve", "embedding_bag", "interactions", "flash_attention",
            "flash_decode")))
    for load in (fused_serve._lib, embedding_bags._lib,
                 feature_interactions._lib, attention._attention_lib,
                 attention._decode_lib):
        load()
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; allow_tf32 matmul=False cudnn=False")
    build_all()

    errs = phase_kernels(dev)
    none, none_launches, serial, open_loop = phase_main_none(dev)
    auto, auto_d1, auto_run = phase_main_auto(dev, none)
    times = phase_timing(none, auto, dev)
    print(f"[serve] plan=none per query, closed loop: p50 "
          f"{serial.p50_ms:.4f} ms, p99 {serial.p99_ms:.4f} ms; open loop "
          f"at {open_loop.offered_qps:.1f} qps: p50 {open_loop.p50_ms:.4f} "
          f"ms, p99 {open_loop.p99_ms:.4f} ms ({card})")
    s, o = auto_run["serial"], auto_run["open_loop"]
    print(f"[serve] plan=auto per query, closed loop: p50 {s.p50_ms:.4f} "
          f"ms, p99 {s.p99_ms:.4f} ms; open loop at {o.offered_qps:.1f} "
          f"qps: p50 {o.p50_ms:.4f} ms, p99 {o.p99_ms:.4f} ms ({card})")
    profile_flushes(none, "plan=none, planner depth", table=True)
    profile_flushes(auto, "plan=auto, planner depth")
    profile_flushes(auto_d1, "plan=auto, depth 1")
    auto_plan = auto.plan
    del auto, auto_d1
    torch.cuda.empty_cache()
    phase_interleaved(none, auto_plan)
    # 6a and 7a share the stacked tables and the store; the plan=none
    # session then hands its tables over, so 6b holds no more than ~45 GB
    cfg, tables = none.cfg, none.params["tables"]
    store, tiered = phase_tiered(tables, cfg, dev)
    api_serve = phase_api_serve(tables, store, cfg, dev)
    none.params.clear()
    del tables, none
    torch.cuda.empty_cache()
    packed = phase_packed(store, cfg, dev)
    del store
    torch.cuda.empty_cache()
    api_attention = phase_api_attention(dev)
    for more in (tiered[2], api_serve[2], packed[2], api_attention[2]):
        for name, err in more.items():       # the run's largest per kernel
            errs[name] = max(err, errs.get(name, 0.0))

    launches = {"fused_bag_interactions":
                none_launches["fused_bag_interactions"],
                "fused_grouped_bag_interactions":
                auto_run["launches"]["fused_grouped_bag_interactions"],
                **tiered[0], **packed[0], **api_serve[0], **api_attention[0]}
    # each kernel's row: the serve kernels at the depth-8 micro-batch
    # B = 25, the bags at B = 200, attention at the largest shape where
    # the plain version and the library also run
    by_shape = {**times, **api_serve[1], **api_attention[1]}
    measured = {name: rows[25] for name, rows in by_shape.items()
                if 25 in rows}
    measured.update({**tiered[1], **packed[1]})
    measured["flash_attention"] = api_attention[1]["flash_attention"][CHECK_T]
    measured["flash_decode"] = api_attention[1]["flash_decode"][
        TIME_DECODE_B]
    print(json.dumps({"by_batch": by_shape}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "max_scaled_err": errs[(name, "scaled")],
         **measured[name]}
        for name in KERNELS], "not_ported": NOT_PORTED}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
