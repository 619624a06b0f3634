"""Cross-board ROW-RANGE partitioning: one model spread over a fleet's
memory at shard (table, row_lo, row_hi) granularity.

The port's copy of ``repro.fabric.partition`` (pure Python and numpy):
the same shards, byte and load accounting, warnings and refusals.

`core/planner.py` decides where a table lives WITHIN a board (fast vs
bulk tier). This module lifts the same greedy access-density logic one
level up — N boards, each with `board_capacity_bytes` of embedding
memory, collectively own ONE table set — and one level
DOWN in granularity: ownership is a `ShardMap` of row-range shards, the
paper's full-sharding axis (Alg. 1 splits *rows*, not tables) at board
granularity. Whole-table ownership is the trivial one-shard-per-table
case, so every whole-table behavior (pooled wire format, per-owner bag
calls) is preserved exactly when nothing is split — but a table larger than
any single board is no longer unservable: it splits into contiguous
row ranges (`planner.split_table_shards`, hottest head range to the
least-loaded board) and the fleet holds it collectively.

The partitioner budgets every byte (`ShardMap.board_bytes` vs capacity)
and balances expected LOOKUP load, not just bytes: tables are placed
hottest-density-first (`planner.access_density_order`) onto the board
with the least accumulated access mass that still has room, splitting
only when no board fits the whole table. Capacity violations are
errors, not silent spills:

  * `partition_rows(...)` raises only if a row range of
    `min_shard_rows` fits NOwhere — the true fleet-capacity floor;
  * `partition_tables(...)` is the whole-table-granularity entry
    (splitting disabled): it raises when a single table overflows
    every board, naming the table — the whole-table contract, kept for the
    feasibility probes and benches that demonstrate the floor the
    row-range partitioner removes;
  * `fits_one_board(...)` is the probe benches and the CLI use to show
    a config genuinely exceeds one board before the fleet serves it.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.planner import (access_density_order,
                                      default_table_bytes,
                                      split_table_shards)


@dataclass(frozen=True, order=True)
class Shard:
    """One contiguous row range of one table, owned by one board."""

    table: int
    row_lo: int
    row_hi: int          # exclusive
    board: int

    @property
    def n_rows(self) -> int:
        return self.row_hi - self.row_lo


@dataclass(frozen=True)
class ShardMap:
    """Row-range ownership across a sharded fleet + the capacity
    accounting that proves it fits.

    `shards` is the single source of truth, sorted by (table, row_lo) and
    covering every table's [0, rows) exactly once. Everything consumers
    need — per-board residency (`shards_of`), lookup routing
    (`owner_of` / `owner_cuts`), whole-vs-split classification — derives
    from it deterministically.
    """

    config: str
    n_boards: int
    board_capacity_bytes: int
    shards: Tuple[Shard, ...]
    num_tables: int
    rows_per_table: int
    row_bytes: Tuple[int, ...]     # bytes per row, per table
    board_bytes: Tuple[int, ...]   # embedding bytes resident per board
    board_load: Tuple[float, ...]  # expected access mass per board

    # -- byte accounting -----------------------------------------------------
    @property
    def table_bytes(self) -> Tuple[int, ...]:
        return tuple(self.rows_per_table * rb for rb in self.row_bytes)

    @property
    def total_bytes(self) -> int:
        return int(sum(s.n_rows * self.row_bytes[s.table]
                       for s in self.shards))

    def shard_bytes(self, s: Shard) -> int:
        return s.n_rows * self.row_bytes[s.table]

    # -- ownership views -----------------------------------------------------
    def shards_of(self, board: int) -> Tuple[Shard, ...]:
        """Shards board `board` owns, (table, row_lo) ascending — the
        canonical order every consumer (residency split, exchange
        reassembly, migration) derives."""
        return tuple(s for s in self.shards if s.board == board)

    def tables_of(self, board: int) -> Tuple[int, ...]:
        """Table ids with at least one owned row on `board`, ascending."""
        return tuple(sorted({s.table for s in self.shards
                             if s.board == board}))

    def table_shards(self, table: int) -> Tuple[Shard, ...]:
        return tuple(s for s in self.shards if s.table == table)

    @property
    def split_tables(self) -> Tuple[int, ...]:
        """Tables owned by more than one shard (row-range split)."""
        counts: Dict[int, int] = {}
        for s in self.shards:
            counts[s.table] = counts.get(s.table, 0) + 1
        return tuple(sorted(t for t, c in counts.items() if c > 1))

    @property
    def whole_tables(self) -> Tuple[int, ...]:
        split = set(self.split_tables)
        return tuple(t for t in range(self.num_tables) if t not in split)

    @property
    def owner(self) -> Tuple[int, ...]:
        """table_id -> owning board, defined ONLY when every table is a
        single shard (the whole-table special case).
        A split map has no per-table owner — use `owner_of`/`shards_of`."""
        if self.split_tables:
            raise ValueError(
                f"tables {self.split_tables} are row-range split across "
                f"boards; per-table ownership is undefined — route by "
                f"owner_of(table, row)")
        return tuple(s.board for s in self.shards)

    def owner_cuts(self, table: int) -> Tuple[np.ndarray, np.ndarray]:
        """(cuts, owners) for row->board routing within `table`: row r is
        owned by owners[searchsorted(cuts, r, 'right') - 1]."""
        ts = self.table_shards(table)
        return (np.asarray([s.row_lo for s in ts], np.int64),
                np.asarray([s.board for s in ts], np.int64))

    def owner_of(self, table: int, row: int) -> int:
        cuts, owners = self.owner_cuts(table)
        return int(owners[int(np.searchsorted(cuts, row, "right")) - 1])

    def owned_mask(self, board: int) -> np.ndarray:
        """(T, R) bool: rows resident on `board` — the cache's ownership
        currency (its complement is the remote row space)."""
        m = np.zeros((self.num_tables, self.rows_per_table), bool)
        for s in self.shards:
            if s.board == board:
                m[s.table, s.row_lo:s.row_hi] = True
        return m

    # -- health --------------------------------------------------------------
    def load_balance(self) -> float:
        """Peak-to-even ratio of per-board access mass: 1.0 = perfectly
        balanced lookup load, k = the busiest board sees k x its fair
        share. The partitioner optimizes this; tests assert it stays
        near 1 under skewed (Zipf) frequencies."""
        total = sum(self.board_load)
        if total <= 0:
            return 1.0
        return float(max(self.board_load) * self.n_boards / total)

    def peak_fill(self) -> Tuple[float, int]:
        """(fill fraction, board id) of the FULLEST board — named, so a
        near-capacity board is attributable, not an anonymous percentage."""
        b = int(np.argmax(self.board_bytes))
        return (self.board_bytes[b] / max(self.board_capacity_bytes, 1), b)

    def overfull_message(self) -> Optional[str]:
        """The >95%-fill warning text, or None while there is headroom."""
        used, fullest = self.peak_fill()
        if used <= 0.95:
            return None
        return (f"board b{fullest} at {used:.0%} of capacity "
                f"({self.board_bytes[fullest]} of "
                f"{self.board_capacity_bytes} B) — within 5% of overflow")

    def warn_if_overfull(self, stacklevel: int = 3) -> Optional[str]:
        """Warn loudly, like the planner's overflow errors: a board this
        full has no headroom for re-partition staging or profile error.
        Fired at PLAN time by the partitioners AND from summary(), so an
        over-full placement is loud whether or not anyone prints it."""
        msg = self.overfull_message()
        if msg is not None:
            warnings.warn(f"[partition] {msg}", RuntimeWarning,
                          stacklevel=stacklevel)
        return msg

    def summary(self) -> str:
        used, fullest = self.peak_fill()
        loads = " ".join(f"b{i}={l:.2f}" for i, l in enumerate(
            np.asarray(self.board_load) / max(sum(self.board_load), 1e-12)))
        n_split = len(self.split_tables)
        lines = [
            f"[partition] {self.config}: {self.num_tables} tables in "
            f"{len(self.shards)} shards"
            + (f" ({n_split} row-range split)" if n_split else "")
            + f" ({self.total_bytes / 2**20:.2f} MiB) over {self.n_boards} "
            f"boards @ {self.board_capacity_bytes / 2**20:.2f} MiB "
            f"(peak board fill {used:.0%} on b{fullest}); "
            f"load share {loads}"]
        msg = self.warn_if_overfull(stacklevel=3)
        if msg is not None:
            lines.append(f"[partition] WARNING: {msg}")
        return "\n".join(lines)


# Whole-table maps used to be a distinct class; the row-range refactor made
# them the one-shard-per-table case of the same structure.
PartitionMap = ShardMap


def fits_one_board(cfg: DLRMConfig, board_capacity_bytes: int,
                   table_bytes: Optional[Sequence[int]] = None) -> bool:
    """Would the whole table set fit a single board's embedding memory?"""
    t_bytes = (list(table_bytes) if table_bytes is not None
               else default_table_bytes(cfg))
    return sum(t_bytes) <= board_capacity_bytes


def _resolve_row_bytes(cfg: DLRMConfig,
                       table_bytes: Optional[Sequence[int]]) -> List[int]:
    t_bytes = (list(table_bytes) if table_bytes is not None
               else default_table_bytes(cfg))
    if len(t_bytes) != cfg.num_tables:
        raise ValueError(
            f"access_freq/table_bytes must have one entry per table "
            f"({cfg.num_tables}), got {len(t_bytes)}")
    rb = []
    for t, tb in enumerate(t_bytes):
        if tb % cfg.rows_per_table:
            raise ValueError(
                f"table_bytes[{t}]={tb} does not divide into "
                f"{cfg.rows_per_table} rows; row-range accounting needs "
                f"whole bytes per row")
        rb.append(tb // cfg.rows_per_table)
    return rb


def partition_rows(
    cfg: DLRMConfig,
    access_freq,
    n_boards: int,
    board_capacity_bytes: int,
    table_bytes: Optional[Sequence[int]] = None,
    *,
    min_shard_rows: int = 1,
    allow_split: bool = True,
) -> ShardMap:
    """Greedy balanced row-range partition: hottest access density first,
    each table whole to the least-loaded board with room; a table no board
    fits is split into contiguous row ranges (`planner.split_table_shards`)
    instead of raising. See module docstring.

    `access_freq` is per-table (T,) or per-row (T, R); per-row frequencies
    price split shards by the mass of the rows they actually hold.
    """
    if n_boards < 1:
        raise ValueError(f"n_boards must be >= 1, got {n_boards}")
    freq = np.asarray(access_freq, dtype=np.float64)
    if freq.ndim == 1:
        table_freq = freq
        row_freq = None
    elif freq.ndim == 2 and freq.shape[1] == cfg.rows_per_table:
        table_freq = freq.sum(axis=1)
        row_freq = freq
    else:
        raise ValueError(
            f"access_freq must be (T,) or (T, R)=({cfg.num_tables}, "
            f"{cfg.rows_per_table}), got shape {freq.shape}")
    if len(table_freq) != cfg.num_tables:
        raise ValueError(
            f"access_freq/table_bytes must have one entry per table "
            f"({cfg.num_tables}), got {len(table_freq)}/"
            f"{cfg.num_tables if table_bytes is None else len(table_bytes)}")
    row_bytes = _resolve_row_bytes(cfg, table_bytes)
    t_bytes = [rb * cfg.rows_per_table for rb in row_bytes]

    shards: List[Shard] = []
    bytes_used = [0] * n_boards
    load = [0.0] * n_boards
    R = cfg.rows_per_table
    for t in access_density_order(table_freq, t_bytes):
        t = int(t)
        fits = [b for b in range(n_boards)
                if bytes_used[b] + t_bytes[t] <= board_capacity_bytes]
        if fits:
            # least accumulated access mass; bytes then board id break ties
            # so the partition is deterministic in (freq, capacities)
            b = min(fits, key=lambda i: (load[i], bytes_used[i], i))
            shards.append(Shard(t, 0, R, b))
            bytes_used[b] += t_bytes[t]
            load[b] += float(table_freq[t])
            continue
        if not allow_split:
            free = n_boards * board_capacity_bytes - sum(bytes_used)
            raise ValueError(
                f"model does not fit the fleet: table {t} ({t_bytes[t]} B) "
                f"overflows every board ({free} B free across {n_boards} "
                f"boards of {board_capacity_bytes} B; total table set "
                f"{sum(t_bytes)} B)")
        free_rows = [(board_capacity_bytes - bytes_used[b]) // row_bytes[t]
                     for b in range(n_boards)]
        rf = row_freq[t] if row_freq is not None else None
        try:
            ranges = split_table_shards(R, rf, free_rows, load,
                                        min_shard_rows)
        except ValueError as e:
            raise ValueError(
                f"model does not fit the fleet: table {t} cannot be "
                f"row-range split over {n_boards} boards of "
                f"{board_capacity_bytes} B ({e})") from e
        for b, lo, hi in ranges:
            shards.append(Shard(t, lo, hi, b))
            bytes_used[b] += (hi - lo) * row_bytes[t]
            mass = (float(rf[lo:hi].sum()) if rf is not None
                    else float(table_freq[t]) * (hi - lo) / R)
            load[b] += mass
    smap = ShardMap(
        config=cfg.name, n_boards=n_boards,
        board_capacity_bytes=int(board_capacity_bytes),
        shards=tuple(sorted(shards)),
        num_tables=cfg.num_tables, rows_per_table=R,
        row_bytes=tuple(row_bytes),
        board_bytes=tuple(bytes_used), board_load=tuple(load))
    smap.warn_if_overfull()   # loud at PLAN time, not first summary()
    return smap


def partition_tables(
    cfg: DLRMConfig,
    access_freq: Sequence[float],
    n_boards: int,
    board_capacity_bytes: int,
    table_bytes: Optional[Sequence[int]] = None,
) -> ShardMap:
    """Whole-table-granularity partition (splitting disabled), raising
    when a table overflows every board. The feasibility
    probes and benches use it to demonstrate the floor `partition_rows`
    removes; live fleets partition with `partition_rows`."""
    return partition_rows(cfg, access_freq, n_boards, board_capacity_bytes,
                          table_bytes, allow_split=False)
