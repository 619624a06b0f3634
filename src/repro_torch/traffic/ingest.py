"""Ingest external request logs into replayable `QueryEvent` streams.

The port's copy of ``repro.traffic.ingest``. `repro_torch.traffic`
replays its own recorded traces; production capacity
planning starts from MEASURED logs. This adapter takes the common
minimal log shape — JSONL, one request per line with a timestamp and the
item ids it touched:

    {"ts": 1712009423.118, "items": [4481, 912, 33]}

and turns it into the cluster/fleet event currency:

  * arrival process: EXACT — timestamps are sorted and normalized so the
    first request lands at t=0; every queueing/batching number downstream
    reflects the measured inter-arrival gaps, which is what trace-driven
    capacity planning needs.
  * content: APPROXIMATED — query content in this repo is a pure
    function of (step, seed, alpha) so traces stay tiny and replay
    bit-identically; item-id lists from an external system do not map
    onto the synthetic row space. The adapter fits a Zipf skew `alpha`
    to the log's empirical item popularity (log-log rank/frequency
    regression) so the regenerated streams stress the tiered/cached
    row paths like the measured traffic did. Pass `alpha=` to override.

Malformed records (bad JSON, missing/invalid fields) raise
`IngestError` naming the line, or are counted and skipped with
`strict=False`. The result round-trips through `traffic.trace`
record/replay unchanged (tests/test_torch_traffic.py).
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.traffic.scenarios import QueryEvent


class IngestError(ValueError):
    """A request log record the adapter cannot use, with its location."""

    def __init__(self, path: str, line_no: int, reason: str):
        super().__init__(f"{path}:{line_no}: {reason}")
        self.path = path
        self.line_no = line_no
        self.reason = reason


def estimate_zipf_alpha(item_counts) -> float:
    """Zipf skew of an empirical item-popularity histogram: slope of the
    log-log rank/frequency relation (least squares), clipped to [0, 3].
    Degenerate histograms (<2 distinct items) report 0 (uniform)."""
    counts = np.sort(np.asarray(list(item_counts), np.float64))[::-1]
    counts = counts[counts > 0]
    if counts.size < 2:
        return 0.0
    x = np.log(np.arange(1, counts.size + 1, dtype=np.float64))
    y = np.log(counts)
    slope = float(np.polyfit(x, y, 1)[0])
    return float(min(max(-slope, 0.0), 3.0))


def _parse_record(path: str, line_no: int, line: str) -> Tuple[float, List[int]]:
    try:
        d = json.loads(line)
    except json.JSONDecodeError as e:
        raise IngestError(path, line_no, f"invalid JSON ({e.msg})")
    if not isinstance(d, dict):
        raise IngestError(path, line_no,
                          f"record must be an object, got {type(d).__name__}")
    if "ts" not in d or "items" not in d:
        missing = [k for k in ("ts", "items") if k not in d]
        raise IngestError(path, line_no,
                          f"record is missing {', '.join(missing)!r}")
    ts, items = d["ts"], d["items"]
    # float(ts) inside the try: a JSON integer beyond float64 range (legal
    # JSON!) must become an IngestError, not an OverflowError escaping the
    # strict=False skip path
    try:
        ok = (isinstance(ts, (int, float)) and not isinstance(ts, bool)
              and math.isfinite(float(ts)))
    except (OverflowError, ValueError):
        ok = False
    if not ok:
        raise IngestError(path, line_no, f"'ts' must be a finite number, "
                                         f"got {ts!r}")
    if (not isinstance(items, list) or not items
            or not all(isinstance(i, int) and not isinstance(i, bool)
                       and i >= 0 for i in items)):
        raise IngestError(path, line_no,
                          "'items' must be a non-empty list of item ids "
                          "(non-negative integers)")
    return float(ts), items


def ingest_jsonl(path: str, *, seed: int = 0,
                 alpha: Optional[float] = None, start_qid: int = 0,
                 strict: bool = True) -> Tuple[Dict, List[QueryEvent]]:
    """Adapt an external JSONL request log into `QueryEvent`s.

    Returns (meta, events): events in arrival order starting at t=0,
    ready for `Cluster.run` / `ShardedFleet.run` or for
    `traffic.trace.record_trace` (the meta dict slots straight into the
    trace header as provenance). See module docstring for the exactness
    contract; `strict=False` skips malformed records (counted in
    `meta["skipped"]`) instead of raising."""
    arrivals: List[Tuple[float, int]] = []     # (ts, line_no)
    item_freq: Dict[int, int] = {}
    skipped = 0
    with open(path) as f:                      # streamed: logs can be huge
        for line_no, line in enumerate(f, start=1):
            if not line.strip():
                continue
            try:
                ts, items = _parse_record(path, line_no, line)
            except IngestError:
                if strict:
                    raise
                skipped += 1
                continue
            arrivals.append((ts, line_no))
            for i in items:
                item_freq[i] = item_freq.get(i, 0) + 1
    if not arrivals:
        raise IngestError(path, 0, "log has no usable records")
    arrivals.sort()
    t0 = arrivals[0][0]
    est_alpha = (float(alpha) if alpha is not None
                 else estimate_zipf_alpha(item_freq.values()))
    events = [
        QueryEvent(qid=start_qid + k, arrival_s=ts - t0, step=start_qid + k,
                   seed=int(seed), alpha=est_alpha, perm_salt=0)
        for k, (ts, _) in enumerate(arrivals)]
    span = events[-1].arrival_s
    meta = {
        "source": path, "ingested": True, "n": len(events),
        "skipped": skipped, "alpha": est_alpha,
        "alpha_fitted": alpha is None, "seed": int(seed),
        "span_s": span,
        # zero-span logs (one record, identical timestamps) report 0.0, not
        # inf: the meta dict lands in JSON trace headers, and inf would
        # serialize as the non-standard token `Infinity`
        "qps": len(events) / span if span > 0 else 0.0,
        "distinct_items": len(item_freq),
    }
    return meta, events
