"""Tiered-embedding sweep: hot-fraction x Zipf skew (paper Sec. VII-A), on
the card.

The counterpart of ``benchmarks/bench_tiered_embedding.py``, with the
reference's defaults, sweep and additive composition:

  * per-tier SERVICE TIMES (t_bulk: full-table gather, t_fast: hot-slab
    gather, t_translate: index remap) are measured in interleaved rounds
    (CUDA events) and each one's median over the rounds taken;
  * the measured hit ratio h of the tiered store on a held-out stream then
    composes the tiered step:  t = t_translate + h*t_fast + (1-h)*t_bulk
    (additive, no overlap), against the single-tier baseline t_bulk;
  * ``direct_speedup`` is the packed single-gather path's own time.

Every gather goes through row 4 (``ops.embedding_bag``), the translate
step through ``core/tiered_embedding.translate_indices_packed``; streams
come from ``data.recsys.zipf_indices`` on a ``torch.Generator``.
``model_speedup`` is the perf model's projection (RecSpeed hybrid
HBM+DDR4) at the same measured hit ratio.

On the H100 the two tiers are the 50 MB L2 and HBM, not HBM and DDR4: at
the defaults (4 x 524,288 x 64 fp32 = 512 MiB) a 1% hot slab is 5.4 MB and
fits the L2, 10% is 54 MB, at its edge. ``--tables 40 --rows 4194304
--dim 32 --lookups 80 --batch 200`` runs RM2-small's widths (21.47 GB of
tables; the store and its packed copy make ~65 GB at the peak).

  PYTHONPATH=src python -m benchmarks_torch.bench_tiered_embedding
      [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import torch

from benchmarks_torch._artifacts import (device_block, device_label,
                                         print_claims, write_bench_json)
from benchmarks_torch._timing import paired_medians
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import tiered_embedding as te
from repro_torch.core.perf_model import breakdown, recspeed_hybrid_system
from repro_torch.data.recsys import zipf_indices
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

PROFILE_STEPS = 4          # profile pass: stream steps 0..3
EVAL_STEP = 10             # the held-out stream the hit ratio is read on


def _stream(dev: torch.device, step: int, B: int, T: int, L: int, R: int,
            alpha: float) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(1 + step)
    return zipf_indices(gen, (B, T, L), R, alpha)


def sweep_point(tables: torch.Tensor, freq: torch.Tensor,
                eval_idx: torch.Tensor, frac: float, cfg: DLRMConfig
                ) -> Tuple[te.TieredTables, float, float]:
    """The store of ``frac`` hot rows a table built from ``freq``, its
    hit ratio on ``eval_idx``, and the perf model's speedup at that hit
    ratio: (store, hit, model_speedup)."""
    H = max(1, int(tables.shape[1] * frac))
    tiered = te.build_tiered_tables(tables, freq, H)
    hit = float(te.hit_mask(tiered, eval_idx).float().mean())
    hybrid = recspeed_hybrid_system()
    m_hit = breakdown(cfg, hybrid, "inference", hit_ratio=hit)
    m_cold = breakdown(cfg, hybrid, "inference", hit_ratio=0.0)
    return tiered, hit, m_hit.qps / m_cold.qps


def run(T: int, R: int, d: int, L: int, B: int, alphas: List[float],
        hot_fracs: List[float], iters: int, rounds: int, dev: torch.device):
    """Returns (winner_at_target, sweep_rows)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = torch.randn((T, R, d), generator=gen, device=dev)
    cfg = DLRMConfig(name="bench-tiered", num_tables=T, lookups_per_table=L,
                     embed_dim=d, rows_per_table=R, batch_size=B)

    print(f"# tiered embedding sweep: T={T} R={R} d={d} L={L} B={B} "
          f"({T * R * d * 4 / 2**20:.0f} MiB tables) on "
          f"{device_label(device_block(dev))}")
    print("alpha,hot_frac,hit_ratio,tier_contrast,base_qps,tiered_qps,"
          "speedup,direct_speedup,model_speedup")
    winner_at_target = False
    sweep = []
    for alpha in alphas:
        # profile pass (steps 0..3) and a disjoint eval stream (step 10)
        freq = torch.zeros((T, R), dtype=torch.int32, device=dev)
        for s in range(PROFILE_STEPS):
            te.accumulate_row_freq(freq, _stream(dev, s, B, T, L, R, alpha))
        eval_idx = _stream(dev, EVAL_STEP, B, T, L, R, alpha)

        for frac in hot_fracs:
            tiered, hit, model = sweep_point(tables, freq, eval_idx, frac,
                                             cfg)
            H = tiered.hot_slots
            packed = te.packed_tables(tiered)
            slab = tiered.fast[:, :H].contiguous()
            slab_idx = torch.remainder(eval_idx, H)  # all-hot service probe
            phys = te.translate_indices_packed(tiered, eval_idx)

            t_bulk, t_fast, t_trans, t_direct = paired_medians(
                [lambda: ops.embedding_bag(tables, eval_idx),
                 lambda: ops.embedding_bag(slab, slab_idx),
                 lambda: te.translate_indices_packed(tiered, eval_idx),
                 lambda: ops.embedding_bag(packed, phys)],
                rounds, iters, dev)
            del tiered, packed, slab, slab_idx, phys
            if dev.type == "cuda":     # the next store needs whole blocks
                torch.cuda.empty_cache()

            base_qps = B / t_bulk
            t_tiered = t_trans + hit * t_fast + (1.0 - hit) * t_bulk
            tier_qps = B / t_tiered
            speedup = t_bulk / t_tiered
            direct = t_bulk / t_direct
            print(f"{alpha},{frac},{hit:.3f},{t_bulk / t_fast:.2f}x,"
                  f"{base_qps:.0f},{tier_qps:.0f},{speedup:.2f}x,"
                  f"{direct:.2f}x,{model:.2f}x")
            sweep.append({"alpha": alpha, "hot_frac": frac,
                          "hit_ratio": hit,
                          "tier_contrast": t_bulk / t_fast,
                          "base_qps": base_qps, "tiered_qps": tier_qps,
                          "speedup": speedup, "direct_speedup": direct,
                          "model_speedup": model,
                          "t_bulk_ms": t_bulk * 1e3,
                          "t_fast_ms": t_fast * 1e3,
                          "t_translate_ms": t_trans * 1e3,
                          "t_direct_ms": t_direct * 1e3})
            if alpha >= 1.0 and frac <= 0.10 and speedup > 1.0:
                winner_at_target = True
        del freq, eval_idx

    print(f"tiered beats single-tier baseline at Zipf>=1, hot<=10%: "
          f"{winner_at_target}")
    return winner_at_target, sweep


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", type=int, default=4)
    ap.add_argument("--rows", type=int, default=2 ** 19)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--lookups", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--alphas", default="0,1.05")
    ap.add_argument("--hot-fracs", default="0.01,0.05,0.1")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (CI-sized correctness-of-plumbing run)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--emit-json", action="store_true",
                    help="write BENCH_torch_tiered_embedding.json (claims + "
                         "the full sweep)")
    ap.add_argument("--out-dir", default=None,
                    help="where --emit-json writes (default build/bench/)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.rows, args.batch, args.iters, args.rounds = 2 ** 12, 64, 2, 3
    ok, sweep = run(args.tables, args.rows, args.dim, args.lookups,
                    args.batch,
                    [float(a) for a in args.alphas.split(",")],
                    [float(f) for f in args.hot_fracs.split(",")],
                    args.iters, args.rounds, dev)
    if args.emit_json:
        target = [r for r in sweep
                  if r["alpha"] >= 1.0 and r["hot_frac"] <= 0.10]
        best = max(target, key=lambda r: r["speedup"], default=None)
        detail = ("single-tier gather vs measured-composed tiered step at "
                  "Zipf>=1, hot<=10%")
        if best:
            detail += (f": best {best['speedup']:.2f}x at alpha="
                       f"{best['alpha']} hot={best['hot_frac']} "
                       f"(hit {best['hit_ratio']:.3f}, tier contrast "
                       f"{best['tier_contrast']:.2f}x)")
        claims = [("tiered_speedup", ok or args.smoke, detail
                   + (" [smoke: plumbing-only run, claim waived]"
                      if args.smoke and not ok else ""))]
        print_claims("tiered_embedding", claims, device_block(dev))
        write_bench_json("tiered_embedding", claims,
                         {"sweep": sweep, "smoke": args.smoke,
                          "shape": {"tables": args.tables,
                                    "rows": args.rows, "dim": args.dim,
                                    "lookups": args.lookups,
                                    "batch": args.batch}},
                         dev, args.out_dir)
    return 0 if ok or args.smoke else 1


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
