"""Virtual-clock tracing exported as Chrome trace-event JSON.

Every serving layer runs on one merged virtual clock (seconds); the
`Tracer` turns that timeline into the Chrome trace-event format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
so a run loads directly in Perfetto / chrome://tracing. Conventions:

  * one PROCESS (pid) per board/replica plus pid 0 for control
    (arrivals, autoscaler); one THREAD (tid) per lane on a board —
    serve execution, batching queue, fabric, host-swap — registered via
    `track()` so the viewer shows real names;
  * spans are emitted as "B"/"E" pairs (duration events). Producers emit
    with explicit [t0, t1] virtual times; `to_chrome_json()` sorts by
    timestamp with "E" before "B" at ties, which keeps back-to-back
    spans balanced. Within one track spans must nest (contain or be
    disjoint) — the serving layers' busy-horizon discipline guarantees
    it, and tests/test_obs.py enforces it on real runs;
  * `instant()` ("i") marks point decisions (flush reason, scale
    events); `counter()` ("C") tracks evolving values (queue depth,
    fleet size).

Timestamps are microseconds (the format's unit); virtual seconds are
multiplied by 1e6 on the way in.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


class Tracer:
    """Collects trace events on the virtual clock; see module docstring."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self._tracks: Dict[tuple, Dict[str, str]] = {}
        self._seq = 0          # stable tiebreak for equal timestamps

    # -- track registry ------------------------------------------------------
    def track(self, pid: int, tid: int, process: Optional[str] = None,
              thread: Optional[str] = None) -> None:
        """Name a (pid, tid) track. Idempotent; later names win so a
        re-used pid can be re-labeled (e.g. a re-spawned board)."""
        names = self._tracks.setdefault((int(pid), int(tid)), {})
        if process is not None:
            names["process"] = str(process)
        if thread is not None:
            names["thread"] = str(thread)

    # -- event emission ------------------------------------------------------
    def _emit(self, ph: str, name: str, cat: str, ts_s: float, *,
              pid: int, tid: int, extra: Optional[Dict[str, Any]] = None
              ) -> None:
        ev: Dict[str, Any] = {
            "name": str(name), "cat": str(cat), "ph": ph,
            "ts": float(ts_s) * 1e6, "pid": int(pid), "tid": int(tid),
        }
        if extra:
            ev.update(extra)
        ev["_seq"] = self._seq          # stripped on export
        self._seq += 1
        self.events.append(ev)

    def span(self, name: str, cat: str, t0: float, t1: float, *,
             pid: int = 0, tid: int = 0,
             args: Optional[Dict[str, Any]] = None) -> None:
        """One [t0, t1] span (virtual seconds) on track (pid, tid).

        Nested spans must be emitted OUTER-FIRST (the export tiebreak
        closes later-emitted spans first when end times coincide). A
        zero-length span degrades to an instant — a "B"/"E" pair at one
        timestamp would sort E-before-B and unbalance the track.
        """
        if t1 < t0:
            raise ValueError(f"span {name!r} ends before it starts: "
                             f"[{t0}, {t1}]")
        if t1 == t0:
            self.instant(name, cat, t0, pid=pid, tid=tid, args=args)
            return
        self._emit("B", name, cat, t0, pid=pid, tid=tid,
                   extra={"args": dict(args)} if args else None)
        self._emit("E", name, cat, t1, pid=pid, tid=tid)

    def instant(self, name: str, cat: str, t: float, *, pid: int = 0,
                tid: int = 0, args: Optional[Dict[str, Any]] = None) -> None:
        """A point event ("i", thread-scoped)."""
        extra: Dict[str, Any] = {"s": "t"}
        if args:
            extra["args"] = dict(args)
        self._emit("i", name, cat, t, pid=pid, tid=tid, extra=extra)

    def counter(self, name: str, t: float, values: Dict[str, float], *,
                pid: int = 0, tid: int = 0) -> None:
        """A counter sample ("C"): {series: value} at virtual time t."""
        self._emit("C", name, "counter", t, pid=pid, tid=tid,
                   extra={"args": {k: float(v) for k, v in values.items()}})

    # -- export --------------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self.events)

    def to_chrome_json(self) -> Dict[str, Any]:
        """The full trace as a JSON-ready dict (Chrome trace-event object
        format). Metadata ("M") name events come first; timed events are
        sorted by (ts, E-before-B-at-ties, emission order)."""
        meta: List[Dict[str, Any]] = []
        for (pid, tid), names in sorted(self._tracks.items()):
            if "process" in names:
                meta.append({"name": "process_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": names["process"]}})
            if "thread" in names:
                meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                             "tid": tid, "args": {"name": names["thread"]}})
        order = {"E": 0, "B": 2}
        # E before B at equal ts keeps back-to-back spans balanced; among
        # E's at one ts, the LATER-emitted (inner) span closes first, so
        # outer-first emission yields proper nesting even on exact ties
        timed = sorted(
            self.events,
            key=lambda e: (e["ts"], order.get(e["ph"], 1),
                           -e["_seq"] if e["ph"] == "E" else e["_seq"]))
        timed = [{k: v for k, v in e.items() if k != "_seq"} for e in timed]
        return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        """Write the Chrome trace JSON to `path`; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_json(), f)
            f.write("\n")
        return path
