"""The producing end of the delta channel: tables-only online SGD.

The port's counterpart of ``repro.online.trainer``. The online-training
loop is the embedding-dominant regime of Naumov et al. 2020: the dense
MLPs are retrained rarely, but embedding ROWS churn continuously as
behaviour drifts. `OnlineTrainer` is that loop's minimal form -- vanilla
SGD on the EMBEDDING TABLES ONLY against the synthetic stream's planted
logistic teacher (`data/recsys.py`), the dense parameters frozen, so every
update it can emit is a (table, rows, payload) slice, the currency the
fleets' ownership maps and caches speak.

Drift is learnable by construction: the teacher's sparse signal is a
function of the UNROTATED row ids, while `zipf_drift` serves queries
through a rotating row-space permutation (`traffic/scenarios.py`).
`train_steps(salt=...)` trains against the rotated stream, teaching the
CURRENT hot rows the association; `teacher_probs` gives the teacher's
exact click probabilities for any query event.

`OnlineSource` puts the trainer on the virtual clock: at every interval
boundary it runs a fixed number of steps against the drift state at that
instant and emits the changed rows as a `DeltaBatch`. The schedule is a
pure function of (trainer seed, interval, salt function).

How the port computes the reference's results at full width (RM2-small:
21.47 GB of tables):

  * the trainer keeps the reference's canonical host copy of the tables;
    a step gathers the batch's unique rows onto the device, runs the
    forward and backward there in plain torch (the reference trains with
    jnp, not a kernel) and writes the updated rows back. The reference
    takes a dense gradient over every table; rows outside the batch get
    an exactly-zero update there, so the compact update is the same at
    every row;
  * `OnlineSource` builds each batch from the before and after values of
    the rows its steps touched (the reference diffs whole snapshots of
    the tables): under `diff_tables`' ``!=`` rule an untouched row ships
    only when it holds a NaN, and the trainer keeps the set of such rows;
  * the stream is drawn by a ``torch.Generator`` on the trainer's device,
    so its batches differ from ``jax.random``'s.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.dlrm import bce_loss, dlrm_forward_from_pooled
from repro_torch.data.recsys import make_recsys_batch, teacher_click_probs
from repro_torch.device import DeviceArg, resolve_device
from repro_torch.hoststore.chunks import StagingRing, copy_to_host
from repro_torch.models.common import tree_map
from repro_torch.online.delta import DeltaBatch, DeltaChannel, RowDelta
from repro_torch.traffic.scenarios import QueryEvent


def teacher_probs(cfg: DLRMConfig, event: QueryEvent,
                  query_size: Optional[int] = None,
                  device: DeviceArg = None) -> np.ndarray:
    """The planted teacher's exact P(click) for one query event -- the
    ground truth `make_recsys_batch` samples labels from, computed from
    the UNROTATED indices (the teacher predates the drift rotation)."""
    b = make_recsys_batch(cfg, event.step, event.seed, event.alpha,
                          batch_size=query_size, device=device)
    return teacher_click_probs(cfg, b["dense"], b["indices"],
                               event.seed).cpu().numpy()


def expected_logloss(p_teacher: np.ndarray, q_served: np.ndarray,
                     eps: float = 1e-7) -> float:
    """Mean cross-entropy H(p, q) of served click probabilities against
    the teacher's -- the accuracy proxy. Lower is better; minimized when
    the served model reproduces the teacher exactly."""
    p = np.asarray(p_teacher, np.float64)
    q = np.clip(np.asarray(q_served, np.float64), eps, 1.0 - eps)
    return float(np.mean(-(p * np.log(q) + (1.0 - p) * np.log(1.0 - q))))


def _nan_rows(flat: torch.Tensor) -> np.ndarray:
    """Ids of the rows of a (n, d) block that hold a NaN."""
    return torch.nonzero(torch.isnan(flat).any(dim=1)).flatten().numpy()


class OnlineTrainer:
    """Tables-only SGD against the planted-teacher stream; see module
    docstring. Holds the canonical host copy of the tables it trains
    (copied from ``params["tables"]``, a tensor on any device or an
    array; the MLPs are tensors); its steps run on ``device`` (None: the
    card)."""

    def __init__(self, cfg: DLRMConfig, params, *, lr: float = 0.05,
                 seed: int = 0, alpha: float = 0.0,
                 batch_size: Optional[int] = None, start_step: int = 0,
                 device: DeviceArg = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lr = float(lr)
        self.seed = int(seed)
        self.alpha = float(alpha)
        self.batch_size = int(batch_size or cfg.batch_size)
        self.step = int(start_step)
        self._dense_params = {"bot_mlp": params["bot_mlp"],
                              "top_mlp": params["top_mlp"]}
        self._mlps = tree_map(lambda x: x.to(self.device, copy=True),
                              self._dense_params)
        src = params["tables"]
        src = src if torch.is_tensor(src) else torch.from_numpy(
            np.asarray(src))
        T, R, d = src.shape
        if src.device.type == "cuda":
            self._tables = torch.empty((T, R, d), dtype=torch.float32)
            ring = StagingRing(src.device, torch.float32)
            for t in range(T):
                copy_to_host(self._tables[t], src[t].float(), ring)
        else:
            self._tables = src.to(torch.float32, copy=True).contiguous()
        self._flat = self._tables.view(T * R, d)
        # flat ids of the rows holding a NaN, kept through every write; a
        # table whose sum is finite holds none
        self._nan = np.concatenate(
            [np.zeros(0, np.int64)]
            + [_nan_rows(self._tables[t]) + t * R for t in range(T)
               if not torch.isfinite(self._tables[t].sum())]
        ).astype(np.int64)
        # (flat ids, values before the step) of every step since the
        # last `pop_touched`
        self._touched: List[Tuple[np.ndarray, torch.Tensor]] = []

    @property
    def tables(self) -> np.ndarray:
        """Host canonical (T, R, d) float32 -- the trainer's latest state
        (a view, not a copy)."""
        return self._tables.numpy()

    @property
    def nan_rows(self) -> np.ndarray:
        """Sorted flat ``t * R + row`` ids of the rows holding a NaN."""
        return self._nan

    def params(self):
        """Serving-ready stacked params: frozen dense + current tables
        (the host tensor itself, as fleets take their tables)."""
        return {**self._dense_params, "tables": self._tables}

    def pop_touched(self) -> List[Tuple[np.ndarray, torch.Tensor]]:
        """The (sorted flat row ids, their values before the step) of each
        step since the last call, oldest first; clears them."""
        out, self._touched = self._touched, []
        return out

    def _sgd(self, dense: torch.Tensor, idx: torch.Tensor,
             labels: torch.Tensor) -> float:
        """One step on the batch's unique rows; see module docstring."""
        T, R = self.cfg.num_tables, self.cfg.rows_per_table
        dev = self.device
        flat = (idx.to(dev).long()
                + torch.arange(T, device=dev)[None, :, None] * R)
        uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
        ids = uniq.cpu()
        before = self._flat.index_select(0, ids)
        rows = before.to(dev).detach().requires_grad_()
        pooled = rows[inv].sum(dim=2)                     # (B, T, d)
        loss = bce_loss(dlrm_forward_from_pooled(
            self._mlps, dense.to(dev), pooled), labels.to(dev))
        (g,) = torch.autograd.grad(loss, rows)
        after = (rows.detach() - self.lr * g).cpu()
        self._flat.index_copy_(0, ids, after)
        ids_np = ids.numpy()
        nan = ids_np[_nan_rows(after)]
        if self._nan.size or nan.size:
            self._nan = np.union1d(np.setdiff1d(self._nan, ids_np,
                                                assume_unique=True), nan)
        self._touched.append((ids_np, before))
        return float(loss.detach())

    def train_steps(self, n_steps: int, *, salt: int = 0) -> float:
        """Run ``n_steps`` SGD steps on the stream, with the drift rotation
        ``salt`` applied to the index stream (training sees the SAME
        rotated ids serving sees at that instant). Returns the mean
        loss. Deterministic in (seed, step range, salt)."""
        R = self.cfg.rows_per_table
        losses: List[float] = []
        for _ in range(max(0, int(n_steps))):
            b = make_recsys_batch(self.cfg, self.step, self.seed,
                                  self.alpha, batch_size=self.batch_size,
                                  device=self.device)
            idx = b["indices"]
            if salt:
                idx = ((idx.long() + salt % R) % R).to(torch.int32)
            losses.append(self._sgd(b["dense"], idx, b["labels"]))
            self.step += 1
        return float(np.mean(losses)) if losses else float("nan")


class OnlineSource:
    """The trainer on the virtual clock: a lazy `next_time()`/`poll(now)`
    schedule the fleet event loop merges with query arrivals and batch
    deadlines (the protocol `DeltaChannel` speaks, so a RECORDED stream
    drops in wherever a live source does).

    Every ``interval_s`` of virtual time it runs ``steps_per_update`` SGD
    steps against the drift state at the boundary (``salt_fn(t)`` -- wire
    the scenario's ``stream_params(t)[1]`` for zipf_drift) and emits the
    changed rows as one versioned `DeltaBatch`: the batch
    ``diff_tables(snapshot, tables)`` gives for the snapshot the source
    took at its start or last emit."""

    def __init__(self, trainer: OnlineTrainer, *, interval_s: float,
                 steps_per_update: int = 1, start_s: Optional[float] = None,
                 n_updates: Optional[int] = None,
                 salt_fn: Optional[Callable[[float], int]] = None):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.trainer = trainer
        self.interval_s = float(interval_s)
        self.start_s = float(interval_s if start_s is None else start_s)
        self.steps_per_update = int(steps_per_update)
        self.n_updates = n_updates
        self.salt_fn = salt_fn
        self._k = 0
        trainer.pop_touched()              # the snapshot is the tables now
        self.emitted: List[DeltaBatch] = []

    def next_time(self) -> Optional[float]:
        if self.n_updates is not None and self._k >= self.n_updates:
            return None
        return self.start_s + self._k * self.interval_s

    def _diff(self, version: int, t_emit_s: float, loss: float
              ) -> DeltaBatch:
        """The rows whose values changed since the snapshot (under
        ``!=``: each touched row's before and after values), with every
        row that holds a NaN, as full-row payloads."""
        tr = self.trainer
        T, R = tr.cfg.num_tables, tr.cfg.rows_per_table
        d = tr.cfg.embed_dim
        touched = tr.pop_touched()
        ids = np.zeros(0, np.int64)
        vals = np.zeros((0, d), np.float32)
        if touched:
            ids, first = np.unique(np.concatenate([i for i, _ in touched]),
                                   return_index=True)
            before = torch.cat([v for _, v in touched])[
                torch.from_numpy(first)].numpy()
            vals = tr._flat.index_select(0, torch.from_numpy(ids)).numpy()
            keep = np.any(before != vals, axis=1)
            ids, vals = ids[keep], vals[keep]
        nan = np.setdiff1d(tr.nan_rows, ids, assume_unique=True)
        if nan.size:
            ids = np.concatenate([ids, nan])
            vals = np.concatenate([vals, tr._flat.index_select(
                0, torch.from_numpy(nan)).numpy()])
            order = np.argsort(ids, kind="stable")
            ids, vals = ids[order], vals[order]
        cuts = np.searchsorted(ids, np.arange(T + 1, dtype=np.int64) * R)
        deltas = tuple(
            RowDelta(table=t, rows=ids[a:b] - t * R, values=vals[a:b])
            for t, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])) if b > a)
        return DeltaBatch(version=version, t_emit_s=t_emit_s, step=tr.step,
                          deltas=deltas, train_loss=loss)

    def poll(self, now: float) -> List[DeltaBatch]:
        """Train + emit every scheduled batch with t_emit_s <= now."""
        out: List[DeltaBatch] = []
        while True:
            t = self.next_time()
            if t is None or t > now:
                break
            salt = int(self.salt_fn(t)) if self.salt_fn is not None else 0
            loss = self.trainer.train_steps(self.steps_per_update, salt=salt)
            batch = self._diff(self._k + 1, t, loss)
            self._k += 1
            self.emitted.append(batch)
            out.append(batch)
        return out

    def run_to(self, t_end: float) -> DeltaChannel:
        """Eagerly generate every batch scheduled up to ``t_end`` and hand
        them back as a fresh `DeltaChannel` -- the record-then-replay path
        both fleet sizes (and both arms of a comparison) consume."""
        self.poll(t_end)
        return DeltaChannel(self.emitted)
