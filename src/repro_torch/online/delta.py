"""The delta channel: versioned per-row embedding updates in flight.

The port's counterpart of ``repro.online.delta``. A trainer keeps
producing new embedding rows while the serving fleet takes traffic; the
unit of that stream is the `DeltaBatch`, a VERSIONED set of (table, rows,
payload) slices stamped with the virtual-clock time it was emitted:

  * the fleets apply batches ATOMICALLY at update barriers on the virtual
    clock (`ShardedFleet.run(online=...)`, `Cluster.run(online=...)`), so
    a query's served values are a pure function of (query content,
    #batches emitted at or before its arrival);
  * the coherence protocol (`online/coherence.py`) propagates or
    invalidates exactly the rows a batch names;
  * the staleness histogram measures ``visible - t_emit_s`` per batch.

Payloads are host numpy arrays, as in the reference. `DeltaChannel` is
the FIFO between trainer and fleet and the RECORDING surface: `record` /
`load` round-trip a channel through JSONL (one batch per line) in the
reference's format, so a file written by either package loads in the
other and replays bit-exactly.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

# wire accounting constants, matching fabric/exchange.py: payloads ship
# at bf16 precision, row ids as int32
ELEM_BYTES = 2
INDEX_BYTES = 4

# elements of one table slice compared at a time by `diff_tables`: a
# whole (T, R, d) boolean at full width would be 5.4 GB
DIFF_CHUNK_ELEMS = 1 << 25


@dataclass(frozen=True)
class RowDelta:
    """One table's slice of an update batch: new values for named rows."""

    table: int
    rows: np.ndarray       # (n,) int64 sorted unique global row ids
    values: np.ndarray     # (n, d) float32 full replacement payloads

    def __post_init__(self):
        object.__setattr__(self, "rows", np.asarray(self.rows, np.int64))
        object.__setattr__(self, "values",
                           np.asarray(self.values, np.float32))
        if self.rows.ndim != 1 or self.values.ndim != 2 \
                or len(self.rows) != len(self.values):
            raise ValueError(
                f"RowDelta wants rows (n,) + values (n, d), got "
                f"{self.rows.shape} / {self.values.shape}")

    @property
    def n_rows(self) -> int:
        return int(len(self.rows))

    def payload_bytes(self) -> int:
        """Wire size of this slice: row ids + bf16 row payloads."""
        d = self.values.shape[1]
        return self.n_rows * (INDEX_BYTES + d * ELEM_BYTES)


@dataclass(frozen=True)
class DeltaBatch:
    """One versioned update: every row the trainer touched since the
    previous version, stamped with its emit time on the virtual clock."""

    version: int
    t_emit_s: float
    step: int                       # trainer step that produced it
    deltas: Tuple[RowDelta, ...]
    train_loss: float = float("nan")

    @property
    def n_rows(self) -> int:
        return sum(d.n_rows for d in self.deltas)

    @property
    def tables(self) -> Tuple[int, ...]:
        return tuple(d.table for d in self.deltas)

    def payload_bytes(self) -> int:
        return sum(d.payload_bytes() for d in self.deltas)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def diff_tables(old, new, *, version: int, t_emit_s: float, step: int = 0,
                train_loss: float = float("nan")) -> DeltaBatch:
    """Delta-encode two stacked (T, R, d) table snapshots: every row where
    any element compares unequal (``!=``, elementwise: a 0.0 -> -0.0 row
    ships nothing, a row holding a NaN always ships) becomes a full-row
    payload of ``new``. Either snapshot may be a numpy array or a tensor
    on any device; the compare runs a slice of rows at a time, on the card
    when either snapshot lies there."""
    old, new = _tensor(old), _tensor(new)
    if tuple(old.shape) != tuple(new.shape):
        raise ValueError(f"snapshot shapes differ: {tuple(old.shape)} vs "
                         f"{tuple(new.shape)}")
    dev = new.device if new.device.type != "cpu" else old.device
    T, R = new.shape[0], new.shape[1]
    step_rows = max(1, DIFF_CHUNK_ELEMS // max(1, new[0, :1].numel()))
    deltas: List[RowDelta] = []
    for t in range(T):
        rows = []
        for a in range(0, R, step_rows):
            b = min(a + step_rows, R)
            o, n = old[t, a:b].to(dev), new[t, a:b].to(dev)
            rows.append(torch.nonzero((o != n).flatten(1).any(dim=1))
                        .flatten() + a)
        changed = torch.cat(rows)
        if changed.numel():
            idx = changed.to(new.device)
            deltas.append(RowDelta(
                table=int(t), rows=changed.cpu().numpy(),
                values=new[t].index_select(0, idx).cpu().numpy()))
    return DeltaBatch(version=int(version), t_emit_s=float(t_emit_s),
                      step=int(step), deltas=tuple(deltas),
                      train_loss=float(train_loss))


class DeltaChannel:
    """FIFO of `DeltaBatch`es ordered by emit time -- the pipe between a
    trainer (`push`) and the serving event loop (`next_time`/`poll`).

    The fleet merges `next_time()` into its event loop exactly like
    query arrivals and batch deadlines; `poll(now)` drains every batch
    emitted at or before `now`, in version order."""

    def __init__(self, batches: Iterable[DeltaBatch] = ()):
        self._queue: List[DeltaBatch] = sorted(
            batches, key=lambda b: (b.t_emit_s, b.version))
        self.emitted: List[DeltaBatch] = list(self._queue)

    def __len__(self) -> int:
        return len(self._queue)

    def push(self, batch: DeltaBatch) -> None:
        if self._queue and batch.t_emit_s < self._queue[-1].t_emit_s:
            raise ValueError(
                f"delta channel is time-ordered: push at "
                f"t={batch.t_emit_s} after t={self._queue[-1].t_emit_s}")
        self._queue.append(batch)
        self.emitted.append(batch)

    def next_time(self) -> Optional[float]:
        """Emit time of the earliest pending batch; None when drained."""
        return self._queue[0].t_emit_s if self._queue else None

    def poll(self, now: float) -> List[DeltaBatch]:
        """Pop every batch with t_emit_s <= now, in order."""
        out: List[DeltaBatch] = []
        while self._queue and self._queue[0].t_emit_s <= now:
            out.append(self._queue.pop(0))
        return out

    # -- record / replay (traffic.trace's JSONL discipline) ------------------
    def record(self, path: str) -> int:
        """Write every batch this channel has EVER seen (drained or
        pending) as JSONL; returns the batch count."""
        with open(path, "w") as f:
            for b in self.emitted:
                f.write(json.dumps({
                    "version": b.version, "t_emit_s": b.t_emit_s,
                    "step": b.step, "train_loss": b.train_loss,
                    "deltas": [{"table": d.table,
                                "rows": d.rows.tolist(),
                                "values": d.values.tolist()}
                               for d in b.deltas]}) + "\n")
        return len(self.emitted)

    @classmethod
    def load(cls, path: str) -> "DeltaChannel":
        batches: List[DeltaBatch] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                batches.append(DeltaBatch(
                    version=int(doc["version"]),
                    t_emit_s=float(doc["t_emit_s"]),
                    step=int(doc["step"]),
                    train_loss=float(doc.get("train_loss", float("nan"))),
                    deltas=tuple(
                        RowDelta(table=int(d["table"]),
                                 rows=np.asarray(d["rows"], np.int64),
                                 values=np.asarray(d["values"], np.float32))
                        for d in doc["deltas"])))
        return cls(batches)
