"""Sharded fleet walkthrough through the port: serve a model too big for
any one board, on the card (``--device cpu`` runs it on the host).

Three snapshots of ``repro_torch.fabric`` on the reduced RM2 config, at
the reference's sizes:

  1. capacity -- the table set exceeds one board's budget (the 1-board
     partition raises); a 2-board fleet holds and serves it within a
     generous SLA. The first lines budget the config's nominal fp16
     bytes, as the reference's; the port stores fp32, so its boards get
     the same 1.25 x fair share of those bytes;
  2. locality -- the remote-row LFU cache cuts the cross-board wire
     bytes a query, at identical served results;
  3. link sensitivity -- the same trace under a 100x slower fabric link:
     tail latency pays, wire bytes don't change.

Run: PYTHONPATH=src python examples_torch/fabric_sharding.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs.registry import get_dlrm
from repro_torch.core import perf_model
from repro_torch.device import resolve_device
from repro_torch.engine import Engine
from repro_torch.fabric import fits_one_board, partition_tables
from repro_torch.traffic import make_scenario


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(get_dlrm("dlrm-rm2-small-unsharded").reduced(),
                              batch_size=8, rows_per_table=512)
    cap = int(np.ceil(1.25 * cfg.embedding_bytes / 2))   # < the table set
    print(f"tables: {cfg.embedding_bytes} B, board budget: {cap} B, "
          f"fits one board: {fits_one_board(cfg, cap)}")
    try:
        partition_tables(cfg, np.ones(cfg.num_tables), 1, cap)
    except ValueError as e:
        print(f"1-board partition refuses: {e}\n")
    # the port budgets the bytes it stores: fp32 rows
    fp32 = cfg.num_tables * cfg.rows_per_table * cfg.embed_dim * 4
    cap32 = int(np.ceil(1.25 * fp32 / 2))
    print(f"the port's fp32 tables: {fp32} B, board budget: {cap32} B, on "
          f"{dev}")

    # profile deeper than the engine's planning default: the LFU elections
    # (partition load + cache head) sharpen with more observed batches
    engine = Engine(cfg, alpha=1.05, seed=0, profile_batches=32, device=dev)
    events = make_scenario("stationary", alpha=1.05).events(
        80, qps=60.0, seed=0)
    remote_rows = (cfg.num_tables // 2) * cfg.rows_per_table

    runs = {}
    for label, kw in (
        ("cache on ", dict(cache_rows=remote_rows // 2)),
        ("cache off", dict(cache_rows=0, cache_enabled=False)),
        ("slow link", dict(cache_rows=0, cache_enabled=False,
                           link=perf_model.fabric_link(100.0, 100.0))),
    ):
        fleet = engine.sharded_fleet(
            n_boards=2, board_capacity_bytes=cap32, router="jsq",
            max_batch_queries=4, max_wait_ms=25.0, **kw)
        r = fleet.run(events, sla_ms=1000.0, percentile=95.0,
                      scenario="stationary")
        runs[label] = ({e.qid: fleet.completed[e.qid].probs
                        for e in events}, r)
        del fleet
        print(f"{label}: p50={r.p50_ms:7.2f}ms p95={r.ppf_ms:7.2f}ms "
              f"wire={r.bytes_per_query:6.0f} B/query "
              f"{'PASS' if r.ok else 'FAIL'}")

    on, off = runs["cache on "], runs["cache off"]
    print(f"\nremote-row cache: {off[1].bytes_per_query:.0f} -> "
          f"{on[1].bytes_per_query:.0f} B/query "
          f"({off[1].bytes_per_query / on[1].bytes_per_query:.1f}x less "
          f"wire traffic)")
    same = all(np.array_equal(on[0][e.qid], off[0][e.qid]) for e in events)
    print(f"served results identical with cache on/off: {same}")


if __name__ == "__main__":
    main()
