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
     kernel and 4 through the packed embedding-bag kernel (4 launches
     each), all against ``embedding_bag_ref``; both kernels are also held
     against their plain versions and timed.

Each phase prints its peak device memory. The line before the last holds
the per-kernel JSON; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
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
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
HOT_PER_TABLE = 65_536
TIERED_ALPHA = 1.05
GB = 1e9

KERNELS = {
    "fused_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:134"),
    "fused_grouped_bag_interactions": (
        "src/repro_torch/kernels/csrc/fused_serve.cu",
        "src/repro/kernels/fused_serve.py:244"),
    "embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:45"),
    "cached_embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/cached_embedding_bag.py:47"),
}


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
    errs.setdefault(kernel, []).append(abs_err)


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
def library_version(tables, ids, bot, li, lj):
    """F.embedding_bag(mode="sum") + torch.bmm + the tril gather: the
    library yardstick, timed here and never called by the port."""
    pooled = library_bag(tables, ids)
    a = torch.cat([bot[:, None, :], pooled], dim=1)
    f = torch.bmm(a, a.transpose(1, 2))
    return torch.cat([bot, f[:, li, lj]], dim=1)


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
    a = torch.cat([bot[:, None, :], pooled.index_select(1, inv)], dim=1)
    f = torch.bmm(a, a.transpose(1, 2))
    return torch.cat([bot, f[:, li, lj]], dim=1)


def distinct_rows(ids, rows_per_table):
    T = ids.shape[1]
    return torch.unique(
        ids.long() + torch.arange(T, device=ids.device)[None, :, None]
        * rows_per_table).numel()


def least_time(nbytes, flops):
    """(ms, "bytes" | "operations"): the larger of bytes over HBM bandwidth
    and fp32 operations over the fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    return (*least_time(nbytes, flops), nbytes)


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


def report_time(name, shape, k_ms, p_ms, l_ms, bounds):
    b_ms = float(np.mean([b[0] for b in bounds]))
    nbytes = float(np.mean([b[2] for b in bounds]))
    print(f"[time] {name} {shape}: kernel {k_ms:.4f} ms, bound {b_ms:.4f} "
          f"ms ({nbytes / 1e6:.2f} MB at 3.35 TB/s, {bounds[0][1]}; "
          f"{b_ms / k_ms:.1%} of it), plain {p_ms:.4f} ms, library "
          f"{l_ms:.4f} ms, kernel rate {nbytes / k_ms / 1e9:.3f} TB/s")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=bounds[0][1])


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
            time_ms(lambda k: fused_serve.fused_bag_interactions(
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
            time_ms(lambda k: fused_serve.fused_grouped_bag_interactions(
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
def phase_tiered(none, dev):
    """The tiered runtime at full width on the plan=none session's weights.
    The other serve sessions are gone; the plan=none session hands its
    stacked tables over once the store's bulk tier holds them, so no more
    than ~45 GB are resident."""
    from repro_torch.core import tiered_embedding as te
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.kernels import embedding_bags, ops, ref

    cfg = none.cfg
    tables = none.params["tables"]
    T, R, d = tables.shape
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
    stream = [make_recsys_batch(cfg, 10 + s, 0, TIERED_ALPHA)["indices"]
              for s in range(4)]
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
    uniform = torch.randint(0, R, stream[0].shape, device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(device=dev)
                            .manual_seed(7))
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
    del tables, wants, counts
    none.params.clear()
    torch.cuda.empty_cache()
    peak_line("phase 6a (tiered store, cached bag)")

    packed = te.packed_tables(store)
    bulk_view = store.bulk[:, :R]
    ops.reset_launch_counts()
    pools = [te.tiered_embedding_bag_packed(packed, store, i) for i in stream]
    launches["embedding_bag"] = ops.launch_counts["embedding_bag"]
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
    times["embedding_bag"] = time_b4(packed, psets)
    print(f"[tiered] launches {launches} (4 batches each)")
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
        bounds.append((*least_time(nbytes, 2 * B * T * L * d), nbytes))
    return report_time(
        "cached_embedding_bag",
        f"B={B} T={T} L={L} d={d} S+1={fast.shape[1]} R+1={bulk.shape[1]} "
        f"fp32, alpha={TIERED_ALPHA} stream",
        time_ms(lambda k: embedding_bags.cached_embedding_bag(
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
        bounds.append((*least_time(nbytes, B * T * L * d), nbytes))
    return report_time(
        "embedding_bag",
        f"B={B} T={T} L={L} d={d} rows={packed.shape[1]} (packed store) "
        f"fp32, alpha={TIERED_ALPHA} stream",
        time_ms(lambda k: embedding_bags.embedding_bag(packed, sets[k]),
                len(sets)),
        time_ms(lambda k: ref.embedding_bag_ref(packed, sets[k]), len(sets),
                iters=16),
        time_ms(lambda k: library_bag(packed, sets[k]), len(sets), iters=16),
        bounds)


def build_all():
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import _build, embedding_bags, fused_serve
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(_build.build, ("fused_serve", "embedding_bag")))
    fused_serve._lib()
    embedding_bags._lib()
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
    tiered_launches, tiered_times, tiered_errs = phase_tiered(none, dev)
    del none
    for name, err in tiered_errs.items():     # the run's largest per kernel
        errs[name] = max(err, errs.get(name, 0.0))

    launches = {"fused_bag_interactions":
                none_launches["fused_bag_interactions"],
                "fused_grouped_bag_interactions":
                auto_run["launches"]["fused_grouped_bag_interactions"],
                **tiered_launches}
    measured = {name: rows[25] for name, rows in times.items()}
    measured.update(tiered_times)
    print(json.dumps({"by_batch": times}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": errs[name], **measured[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
