"""JSONL traffic traces: record a scenario's event stream, replay it later.

The port's copy of ``repro.traffic.trace``, with the same header and
records, so a trace recorded by either package loads in the other.
Every cluster run is reproducible because the thing that varies — the
traffic — is just a list of `QueryEvent`s, and query CONTENT is a pure
function of the event (`scenarios.materialize_query`). Recording the
events therefore records the whole workload; replaying a trace is
bit-identical to live generation (tests/test_torch_traffic.py holds
both packages to it).

Format: line 1 is a header object ({"trace_version": 1, "scenario": ...,
"qps": ..., "n": ..., "seed": ...} plus free-form provenance), each
following line one event. Floats round-trip exactly through json (repr
serialization), so arrival times and alphas survive unchanged.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from repro_torch.traffic.scenarios import QueryEvent, TrafficScenario

TRACE_VERSION = 1


def record_trace(path: str, events: List[QueryEvent],
                 scenario: Optional[TrafficScenario] = None,
                 **meta) -> None:
    """Write events (+ provenance metadata) as JSONL."""
    header = {"trace_version": TRACE_VERSION, "n": len(events), **meta}
    if scenario is not None:
        header.setdefault("scenario", scenario.name)
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for e in events:
            f.write(json.dumps({
                "qid": e.qid, "t": e.arrival_s, "step": e.step,
                "seed": e.seed, "alpha": e.alpha, "salt": e.perm_salt,
            }) + "\n")


def load_trace(path: str) -> Tuple[Dict, List[QueryEvent]]:
    """Read a trace back: (header metadata, events in arrival order)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"empty trace file: {path}")
    header = json.loads(lines[0])
    if header.get("trace_version") != TRACE_VERSION:
        raise ValueError(
            f"{path}: trace_version {header.get('trace_version')!r} "
            f"unsupported (expected {TRACE_VERSION})")
    events = []
    for ln in lines[1:]:
        d = json.loads(ln)
        events.append(QueryEvent(
            qid=int(d["qid"]), arrival_s=float(d["t"]), step=int(d["step"]),
            seed=int(d["seed"]), alpha=float(d["alpha"]),
            perm_salt=int(d["salt"])))
    if len(events) != int(header.get("n", len(events))):
        raise ValueError(
            f"{path}: header says {header['n']} events, file has "
            f"{len(events)} (truncated trace?)")
    return header, events
