"""Live re-partitioning of a sharded fleet: grow/shrink the board count
mid-trace by MOVING ROW RANGES, not rebuilding the fleet.

The port's copy of ``repro.fabric.elastic`` (pure Python and numpy).

This is the sharded analogue of `runtime/elastic.remesh_tree`: that
module re-plans a device mesh when chips come and go; this one re-plans
a `ShardMap` when BOARDS come and go, and — because embedding rows are
state, not just placement — also computes the minimal row-movement
schedule between the two maps:

  * `expand_map(pm, row_freq)`   — one more board: peel the highest
    access-density row ranges off overloaded boards onto the new one
    until it carries a fair load share. Density-first = most load
    rebalanced per byte moved, the same greedy currency as
    `planner.access_density_order`, so the migration is as small as the
    rebalance allows.
  * `shrink_map(pm, row_freq)`   — retire the LAST board (highest id, so
    surviving boards keep their ids and their resident rows untouched):
    its shards are re-dealt density-first to the least-loaded survivors,
    splitting only when a shard fits nowhere whole.
  * `plan_migration(old, new)`   — diff the two maps into coalesced
    `RowMove`s. Only rows whose owner actually changed appear, so
    `bytes_moved` is exactly the bytes of changed-owner rows — the bound
    `bench_elastic` meters against.

The plan is priced by `perf_model.repartition_time` (busiest endpoint's
send+recv bytes through one port + a latency round) and executed by
`ShardedFleet.apply_migration`, which stalls the virtual clock, moves
the rows, and tells each board's `RemoteRowCache.update_ownership` to
invalidate ONLY migrated rows. Values are frozen, so serving stays
bit-identical to a single full board before, during, and after the
re-partition.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.collectives import Interconnect
from repro_torch.core.perf_model import repartition_time
from repro_torch.core.planner import split_table_shards
from repro_torch.fabric.partition import Shard, ShardMap


@dataclass(frozen=True, order=True)
class RowMove:
    """One contiguous row range changing owner: src board streams rows
    [row_lo, row_hi) of `table` to dst."""

    table: int
    row_lo: int
    row_hi: int      # exclusive
    src: int
    dst: int

    @property
    def n_rows(self) -> int:
        return self.row_hi - self.row_lo


@dataclass(frozen=True)
class MigrationPlan:
    """Minimal row-movement schedule between two ShardMaps."""

    old_n_boards: int
    new_n_boards: int
    moves: Tuple[RowMove, ...]
    rows_moved: int
    bytes_moved: int
    per_board_send_bytes: Tuple[float, ...]
    per_board_recv_bytes: Tuple[float, ...]

    def time_s(self, link: Interconnect) -> float:
        """Seconds the fleet stalls executing this plan over `link`."""
        return repartition_time(self.per_board_send_bytes,
                                self.per_board_recv_bytes, link)

    def summary(self) -> str:
        return (f"[elastic] {self.old_n_boards}->{self.new_n_boards} boards: "
                f"{len(self.moves)} row-range moves, {self.rows_moved} rows "
                f"({self.bytes_moved / 2**20:.2f} MiB)")


# -- grid <-> map ------------------------------------------------------------

def owner_grid(pm: ShardMap) -> np.ndarray:
    """(T, R) int owner-board grid — the mutable currency the elastic
    transforms edit; `grid_to_map` turns it back into a ShardMap."""
    g = np.zeros((pm.num_tables, pm.rows_per_table), np.int32)
    for s in pm.shards:
        g[s.table, s.row_lo:s.row_hi] = s.board
    return g


def grid_to_map(pm: ShardMap, grid: np.ndarray, n_boards: int,
                row_freq: Optional[np.ndarray] = None) -> ShardMap:
    """Rebuild a ShardMap (coalesced runs, byte + load accounting) from an
    owner grid. `pm` supplies config/capacity/row-byte metadata; row mass
    defaults to uniform when no (T, R) frequency profile is given."""
    T, R = pm.num_tables, pm.rows_per_table
    freq = (np.ones((T, R), np.float64) if row_freq is None
            else np.asarray(row_freq, np.float64))
    shards: List[Shard] = []
    bytes_used = [0] * n_boards
    load = [0.0] * n_boards
    for t in range(T):
        row = grid[t]
        cuts = np.flatnonzero(np.diff(row)) + 1
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, R]):
            b = int(row[lo])
            shards.append(Shard(t, int(lo), int(hi), b))
            bytes_used[b] += (hi - lo) * pm.row_bytes[t]
            load[b] += float(freq[t, lo:hi].sum())
    return ShardMap(
        config=pm.config, n_boards=n_boards,
        board_capacity_bytes=pm.board_capacity_bytes,
        shards=tuple(sorted(shards)),
        num_tables=T, rows_per_table=R, row_bytes=pm.row_bytes,
        board_bytes=tuple(bytes_used), board_load=tuple(load))


# -- elastic transforms ------------------------------------------------------

def expand_map(pm: ShardMap, row_freq=None, *,
               min_shard_rows: int = 1) -> ShardMap:
    """New map with one MORE board (id = pm.n_boards), loaded to a fair
    share by peeling density-ordered row ranges off overloaded boards.
    See module docstring for the minimal-movement argument."""
    T, R = pm.num_tables, pm.rows_per_table
    freq = (np.ones((T, R), np.float64) if row_freq is None
            else np.asarray(row_freq, np.float64))
    grid = owner_grid(pm)
    k, new_b = pm.n_boards, pm.n_boards
    load = [float(freq[grid == b].sum()) for b in range(k)] + [0.0]
    target = sum(load) / (k + 1)
    new_bytes = 0

    # donor candidates: every current shard, hottest-per-byte first
    def density(s: Shard) -> float:
        return (float(freq[s.table, s.row_lo:s.row_hi].sum())
                / max(pm.shard_bytes(s), 1))
    for s in sorted(pm.shards, key=lambda s: (-density(s), s)):
        deficit = target - load[new_b]
        if deficit <= 1e-12 * max(target, 1.0):
            break
        surplus = load[s.board] - target
        if surplus <= 0:
            continue           # don't strip a donor below its fair share
        want = min(deficit, surplus)
        room_rows = (pm.board_capacity_bytes - new_bytes) \
            // pm.row_bytes[s.table]
        if room_rows < min(min_shard_rows, s.n_rows):
            continue
        mass = freq[s.table, s.row_lo:s.row_hi]
        if float(mass.sum()) <= want and s.n_rows <= room_rows:
            lo, hi = s.row_lo, s.row_hi          # take the whole shard
        else:
            # take the head prefix (hottest under Zipf) just covering the
            # donor's surplus share of the deficit, bounded by capacity
            cum = np.cumsum(mass)
            cut = int(np.searchsorted(cum, want, "left")) + 1
            cut = max(min(cut, int(room_rows), s.n_rows), min_shard_rows)
            if s.n_rows - cut and s.n_rows - cut < min_shard_rows:
                cut = s.n_rows                   # no sub-minimum remainder
                if cut > room_rows:
                    continue
            lo, hi = s.row_lo, s.row_lo + cut
        grid[s.table, lo:hi] = new_b
        moved = float(freq[s.table, lo:hi].sum())
        load[s.board] -= moved
        load[new_b] += moved
        new_bytes += (hi - lo) * pm.row_bytes[s.table]
    return grid_to_map(pm, grid, k + 1, freq)


def shrink_map(pm: ShardMap, row_freq=None, *,
               min_shard_rows: int = 1) -> ShardMap:
    """New map with one FEWER board: the LAST board (highest id — so the
    survivors keep their ids and resident rows) retires, its shards
    re-dealt density-first to the least-loaded survivor with room.
    Raises ValueError when the survivors cannot absorb the victim's rows."""
    if pm.n_boards < 2:
        raise ValueError("cannot shrink a 1-board fleet")
    T, R = pm.num_tables, pm.rows_per_table
    freq = (np.ones((T, R), np.float64) if row_freq is None
            else np.asarray(row_freq, np.float64))
    grid = owner_grid(pm)
    k = pm.n_boards - 1
    victim = k
    load = [float(freq[grid == b].sum()) for b in range(k)]
    bytes_used = list(pm.board_bytes[:k])
    victims = sorted(
        (s for s in pm.shards if s.board == victim),
        key=lambda s: (-float(freq[s.table, s.row_lo:s.row_hi].sum())
                       / max(pm.shard_bytes(s), 1), s))
    for s in victims:
        free_rows = [(pm.board_capacity_bytes - bytes_used[b])
                     // pm.row_bytes[s.table] for b in range(k)]
        try:
            ranges = split_table_shards(
                s.n_rows, freq[s.table, s.row_lo:s.row_hi],
                free_rows, load, min_shard_rows)
        except ValueError as e:
            raise ValueError(
                f"cannot shrink to {k} boards: shard (table {s.table}, "
                f"rows [{s.row_lo}, {s.row_hi})) fits nowhere ({e})") from e
        for b, a, c in ranges:
            grid[s.table, s.row_lo + a:s.row_lo + c] = b
            load[b] += float(freq[s.table, s.row_lo + a:s.row_lo + c].sum())
            bytes_used[b] += (c - a) * pm.row_bytes[s.table]
    return grid_to_map(pm, grid, k, freq)


# -- diffing -----------------------------------------------------------------

def plan_migration(old: ShardMap, new: ShardMap) -> MigrationPlan:
    """Coalesced row moves between two maps of the SAME model. Every move
    is a row range whose owner differs between the maps, so bytes_moved
    is by construction exactly the bytes of changed-owner rows."""
    if (old.num_tables, old.rows_per_table) != (new.num_tables,
                                                new.rows_per_table):
        raise ValueError(
            f"maps describe different models: "
            f"{old.num_tables}x{old.rows_per_table} vs "
            f"{new.num_tables}x{new.rows_per_table}")
    g_old, g_new = owner_grid(old), owner_grid(new)
    n = max(old.n_boards, new.n_boards)
    moves: List[RowMove] = []
    send = [0.0] * n
    recv = [0.0] * n
    rows_moved = 0
    bytes_moved = 0
    for t in range(old.num_tables):
        o, w = g_old[t], g_new[t]
        changed = o != w
        if not changed.any():
            continue
        # runs of constant (src, dst) within the changed region
        pair = o.astype(np.int64) * n + w
        edges = np.flatnonzero(np.diff(pair)) + 1
        R = old.rows_per_table
        for lo, hi in zip(np.r_[0, edges], np.r_[edges, R]):
            if not changed[lo]:
                continue
            mv = RowMove(t, int(lo), int(hi), int(o[lo]), int(w[lo]))
            moves.append(mv)
            b = mv.n_rows * old.row_bytes[t]
            rows_moved += mv.n_rows
            bytes_moved += b
            send[mv.src] += b
            recv[mv.dst] += b
    return MigrationPlan(
        old_n_boards=old.n_boards, new_n_boards=new.n_boards,
        moves=tuple(sorted(moves)), rows_moved=rows_moved,
        bytes_moved=int(bytes_moved),
        per_board_send_bytes=tuple(send), per_board_recv_bytes=tuple(recv))
