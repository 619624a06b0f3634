#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root, on a CUDA host

Phases; any failure exits non-zero:

  1. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
     and print the card (nvidia-smi name and power limit);
  2. hold each kernel's wrapper against its plain PyTorch version on the
     card, at the main path's shapes and at edge shapes;
  3. drive the main path: ``Engine(get_dlrm("dlrm-rm2-small-unsharded"))``
     at full width (40 tables x 4,194,304 rows x 32, fp32, random weights
     from a seed) serves queries through ``run_serial``,
     ``run_open_loop`` and ``submit``; the kernel's launch count must
     equal the number of flushes, and the probs must be finite, in (0, 1),
     and agree with the composed (plain) path and with the CPU path;
  4. time each kernel with CUDA events beside its bound, its plain
     version and one library yardstick, break a capacity flush down by
     device kernel with torch.profiler, and print the JSON kernel line.

The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX
or of the JAX package ``repro``.
"""
from __future__ import annotations

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
# At R = 4,194,304 a pooled.pooled feature is ~4e-5, so ATOL alone would
# let a 30% error there pass: that block is also held to its own scale,
# max|err| <= SCALED_TOL * max|want| over the block.
SCALED_TOL = 1e-5
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"[chip_smoke] FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


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
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan) and (nan_ok or not nan.any()),
          f"{name}: NaN pattern differs from the plain version")
    g, w = got[~nan], want[~nan]
    abs_err = (g - w).abs().max().item() if g.numel() else 0.0
    rel_err = ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item() \
        if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, rtol=RTOL, atol=ATOL))
    # the pooled.pooled pairs (i > j >= 1) against their own scale
    T, d = ids.shape[1], bot.shape[1]
    lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=got.device)[1]
    pp = (d + torch.nonzero(lj >= 1)[:, 0]) if T > 1 else None
    scaled = 0.0
    if pp is not None:
        gp, wp = got[:, pp], want[:, pp]
        keep = ~torch.isnan(wp)
        scale = wp[keep].abs().max().item() if keep.any() else 0.0
        if scale > 0:
            scaled = (gp - wp)[keep].abs().max().item() / scale
    ok_scaled = scaled <= SCALED_TOL
    print(f"[kernel] fused_bag_interactions {name}: max_abs_err={abs_err:.3e} "
          f"max_rel_err={rel_err:.3e} pooled.pooled err/scale={scaled:.3e} "
          f"{'ok' if ok and ok_scaled else 'OVER TOLERANCE'}")
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"(rtol={RTOL}, atol={ATOL})")
    check(ok_scaled, f"{name}: pooled.pooled block off by {scaled:.3e} of "
                     f"its scale (limit {SCALED_TOL})")
    errs.append(abs_err)


def phase_kernels(dev) -> float:
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = []
    R = 4_194_304
    full = None
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        full = (None if full is None else full.to(dtype))
        for B in (200, 800) + ((1,) if dtype == torch.float32 else ()):
            case = draw_case(B, 40, 80, 32, R, dtype, gen, dev, full)
            full = case[0]
            compare(f"B={B} T=40 L=80 d=32 R={R} {tag}", *case, errs)
    del full, case
    torch.cuda.empty_cache()
    for B, T, L, d, R in ((37, 3, 5, 32, 1000), (16, 8, 4, 128, 128),
                          (16, 1, 4, 32, 64), (8, 4, 8, 256, 64),
                          (4, 100, 2, 128, 64)):   # 52 KB of shared memory
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            compare(f"B={B} T={T} L={L} d={d} R={R} {tag}",
                    *draw_case(B, T, L, d, R, dtype, gen, dev), errs)
    tables, ids, bot = draw_case(16, 8, 4, 32, 128, torch.float32, gen, dev)
    ids[:] = ids[:, :, :1]                       # one row, L times a bag
    compare("repeated ids", tables, ids, bot, errs)
    for dtype in (torch.float32, torch.bfloat16):
        tables, ids, bot = draw_case(64, 8, 16, 32, 1024, dtype, gen, dev)
        tables[:, 0, :] = float("nan")
        ids.clamp_(min=1)
        compare(f"poisoned row 0 never read ({dtype})", tables, ids, bot,
                errs)
    tables, ids, bot = draw_case(8, 4, 6, 32, 64, torch.float32, gen, dev)
    ids[0, 0, 0], ids[1, 1, 1], ids[2, 2, 2] = -1, 64, -65
    compare("out-of-range ids read as jnp.take does", tables, ids, bot, errs,
            nan_ok=True)
    return max(errs)


# ---------------------------------------------------------------- phase 3
def phase_main_path(dev):
    from repro_torch.configs import get_dlrm
    from repro_torch.data.recsys import make_recsys_batch
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry

    cfg = get_dlrm(CONFIG)
    table_bytes = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg)                                  # device None: the card
    sess = eng.serve_session(max_batch_queries=4, warmup=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] {cfg.name}: T={cfg.num_tables} R={cfg.rows_per_table} "
          f"d={cfg.embed_dim} L={cfg.lookups_per_table} B={cfg.batch_size} "
          f"tables {table_bytes / 1e9:.2f} GB fp32 on {sess.device}; "
          f"session built in {build_s:.2f} s, peak allocated "
          f"{peak / 1e9:.2f} GB")
    check(sess.serve_kernel == "fused", f"serve_kernel={sess.serve_kernel}")
    check(sess.params["tables"].is_cuda, "tables are not on the card")
    check(peak < 1.05 * table_bytes, "session holds more than one table copy")
    s1 = sess.measure_service_time(1)
    s4 = sess.measure_service_time(4)
    print(f"[main] service time a flush: 1 query {s1 * 1e3:.3f} ms, "
          f"4 queries {s4 * 1e3:.3f} ms (median of 5)")

    reg = MetricsRegistry()
    ops.reset_launch_counts()
    serial = sess.run_serial(8, metrics=reg)
    open_loop = sess.run_open_loop(16, qps=2.0 / s1, metrics=reg)
    futs = [sess.submit({k: v for k, v in make_recsys_batch(
                cfg, 1000 + i).items() if k != "labels"}, now=i * 1e-4)
            for i in range(4)]                     # the 4th fills the batch
    launches = dict(ops.launch_counts)
    flushes = reg.snapshot()["flush_service_ms"]["count"] + 1
    print(f"[main] launches {launches} over {flushes} flushes "
          f"(8 serial + {flushes - 9} open-loop + 1 submit)")
    print(serial.summary())
    print(open_loop.summary())
    check(all(f.done for f in futs), "submit path left queries pending")
    check(launches["fused_bag_interactions"] == flushes,
          "the kernel's launch count differs from the number of flushes")
    probs = np.stack([f.probs for f in futs])
    check(probs.shape == (4, cfg.batch_size), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all() and (probs > 0).all()
               and (probs < 1).all()), "probs not finite in (0, 1)")

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
    return sess, launches, serial, open_loop


# ---------------------------------------------------------------- phase 4
def library_version(tables, ids, bot, li, lj):
    """F.embedding_bag(mode="sum") + torch.bmm + the tril gather: the
    library yardstick, timed here and never called by the port."""
    T, R, d = tables.shape
    B, _, L = ids.shape
    t = torch.arange(T, device=ids.device)[None, :, None] * R
    flat = (ids.long() + t).view(B * T, L)
    pooled = torch.nn.functional.embedding_bag(
        flat, tables.view(T * R, d), mode="sum").view(B, T, d)
    a = torch.cat([bot[:, None, :], pooled], dim=1)
    f = torch.bmm(a, a.transpose(1, 2))
    return torch.cat([bot, f[:, li, lj]], dim=1)


def bound(tables, ids, bot):
    """Least time for the work: bytes the function must move (the distinct
    rows these ids touch, the ids, bot_out, the output) over HBM bandwidth,
    against its fp32 operations over the fp32 peak."""
    T, R, d = tables.shape
    B, _, L = ids.shape
    pairs = (T + 1) * T // 2
    rows = torch.unique(
        ids.long() + torch.arange(T, device=ids.device)[None, :, None] * R
    ).numel()
    nbytes = (rows * d * tables.element_size() + ids.numel() * 4
              + bot.numel() * 4 + B * (d + pairs) * 4)
    flops = B * T * L * d + B * pairs * 2 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


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


def phase_timing(sess, dev):
    from repro_torch.kernels import fused_serve, ref
    tables = sess.params["tables"]
    T, R, d = tables.shape
    L = sess.cfg.lookups_per_table
    li, lj = torch.tril_indices(T + 1, T + 1, offset=-1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    rows = {}
    for B in (200, 800):
        # 8 input sets in turn: 8 x 82 MB of rows at B=200 overflow the
        # 50 MB L2, so each launch finds its rows cold, as a new query does
        sets = [draw_case(B, T, L, d, R, tables.dtype, gen, dev, tables)[1:]
                for _ in range(8)]
        lib_out = library_version(tables, *sets[0], li, lj)
        check(torch.allclose(lib_out, ref.fused_bag_interactions_ref(
            tables, *sets[0]), rtol=RTOL, atol=ATOL),
            "library yardstick disagrees with the plain version")
        k_ms = time_ms(lambda k: fused_serve.fused_bag_interactions(
            tables, *sets[k]), len(sets))
        p_ms = time_ms(lambda k: ref.fused_bag_interactions_ref(
            tables, *sets[k]), len(sets), iters=16)
        l_ms = time_ms(lambda k: library_version(
            tables, *sets[k], li, lj), len(sets), iters=16)
        bounds = [bound(tables, *s) for s in sets]
        b_ms = float(np.mean([b[0] for b in bounds]))
        nbytes = float(np.mean([b[2] for b in bounds]))
        rows[B] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                       bound_by=bounds[0][1])
        print(f"[time] fused_bag_interactions B={B} T={T} L={L} d={d} "
              f"R={R} fp32: kernel {k_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({nbytes / 1e6:.2f} MB at 3.35 TB/s, {bounds[0][1]}; "
              f"{b_ms / k_ms:.1%} of it), plain {p_ms:.4f} ms, library "
              f"{l_ms:.4f} ms, kernel rate {nbytes / k_ms / 1e9:.3f} TB/s")
    return rows


def profile_flushes(sess):
    """torch.profiler over capacity flushes: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.recsys import make_recsys_batch
    qs = [{k: v for k, v in make_recsys_batch(sess.cfg, 500 + i).items()
           if k != "labels"} for i in range(4)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            sess._execute(qs)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this script runs the port on "
              "the card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, fused_serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; allow_tf32 matmul=False cudnn=False")
    t0 = time.perf_counter()
    lib = _build.build("fused_serve")
    fused_serve._lib()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")

    max_err = phase_kernels(dev)
    sess, launches, serial, open_loop = phase_main_path(dev)
    times = phase_timing(sess, dev)
    print(f"[serve] per query, closed loop: p50 {serial.p50_ms:.4f} ms, "
          f"p99 {serial.p99_ms:.4f} ms; open loop at "
          f"{open_loop.offered_qps:.1f} qps: p50 {open_loop.p50_ms:.4f} ms, "
          f"p99 {open_loop.p99_ms:.4f} ms ({card})")
    profile_flushes(sess)
    print(json.dumps({"B800": {"fused_bag_interactions": times[800]}}))
    print(json.dumps({"kernels": [{
        "name": "fused_bag_interactions", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_serve.cu",
        "replaces": "src/repro/kernels/fused_serve.py:134",
        "launches": launches["fused_bag_interactions"],
        "max_abs_err": max_err, **times[200]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
