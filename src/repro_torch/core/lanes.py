"""Lane scheduler for the grid driver (numpy; own copy of
``repro.core.lanes``, DESIGN.md §12).

``cross_val_path`` runs a fixed pool of S = n_folds * vmap_chunk device
lanes through the engine's chunked fused step. The scheduler owns the
host-side bookkeeping that maps that pool onto the (fold, lambda) work
queue:

  * the queue hands out items lambda-major (all folds of the largest
    remaining lambda first), matching the warm-start order of the
    sequential path driver;
  * after every host sync (`observe`), lanes whose KKT residual passed the
    tolerance — or whose per-item outer budget is exhausted — are RETIRED:
    their results are harvested by `cross_val_path` and their slots freed;
  * freed slots are BACKFILLED from the queue head (`fill`), warm-started
    from the per-fold bank (the densest completed solution of that fold),
    so late rounds run at full occupancy instead of padding every chunk to
    the initial lane count;
  * slots the queue can no longer fill stay DEAD: `cross_val_path` leaves
    their converged device state in place, so they take the fused step's
    skip path, never gate the device loop, and never reach the outputs.

All state is a flat dict of numpy arrays (`state_dict`/`load_state`), so a
grid checkpoint snapshots the scheduler alongside the device lane states
and a resumed grid replays the exact same schedule (resume-equivalence,
tests/test_grid_fault.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["LaneScheduler", "RoundReport", "Retirement"]


@dataclass(frozen=True)
class Retirement:
    """One harvested (fold, lambda) item: where it ran and how it ended."""
    slot: int
    fold: int
    lam_idx: int
    converged: bool
    n_epochs: int


@dataclass
class RoundReport:
    """What one `observe` call decided (the grid's round summary)."""
    active: np.ndarray                 # slots that ran this round
    rec_before: np.ndarray             # telemetry row cursor per active slot
    retired: List[Retirement] = field(default_factory=list)
    continuing: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    bank_updates: List[Tuple[int, int, int]] = field(default_factory=list)
    # ^ (fold, slot, lam_idx): the fold's bank should take this slot's state


class LaneScheduler:
    """Retire-and-backfill scheduler over a fixed pool of device lanes.

    Items are the cells of the (fold, lambda) grid, enumerated
    lambda-major: item k is ``(fold k % F, lambda k // F)`` with lambdas
    sorted decreasing, so every fold sweeps sparse-to-dense exactly like
    the chunked path driver. Each item gets its own ``max_outer`` budget
    (the per-lambda contract of the sequential path); `cross_val_path`
    dispatches blocks of at most ``min(sync_every, min remaining budget)``
    outer iterations between syncs.
    """

    def __init__(self, n_folds: int, n_lambdas: int, n_lanes: int,
                 max_outer: int):
        if n_lanes <= 0 or n_lanes > n_folds * n_lambdas:
            raise ValueError(
                f"n_lanes must be in [1, n_folds*n_lambdas="
                f"{n_folds * n_lambdas}], got {n_lanes}")
        self.n_folds = int(n_folds)
        self.n_lambdas = int(n_lambdas)
        self.n_lanes = int(n_lanes)
        self.max_outer = int(max_outer)
        self.cursor = 0                 # next queue item
        self.n_retired = 0
        S = self.n_lanes
        self.lane_fold = np.full(S, -1, np.int64)   # -1 = free/dead slot
        self.lane_lam = np.full(S, -1, np.int64)
        self.lane_left = np.zeros(S, np.int64)      # remaining outer budget
        self.lane_eps = np.zeros(S, np.int64)       # epochs on current item
        self.lane_rec = np.zeros(S, np.int64)       # telemetry rows recorded
        self.bank_lam = np.full(self.n_folds, -1, np.int64)
        self.bank_gcount = np.zeros(self.n_folds, np.int64)

    # ------------------------------------------------------------- queue
    @property
    def total_items(self) -> int:
        return self.n_folds * self.n_lambdas

    def _item(self, k: int) -> Tuple[int, int]:
        return k % self.n_folds, k // self.n_folds

    @property
    def done(self) -> bool:
        return self.n_retired >= self.total_items

    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self.lane_fold >= 0)

    @property
    def occupancy(self) -> float:
        """Fraction of the lane pool holding live work right now."""
        return float(np.count_nonzero(self.lane_fold >= 0)) / self.n_lanes

    def fill(self) -> List[Tuple[int, int, int]]:
        """Assign queued items to free slots (slot order); returns
        ``[(slot, fold, lam_idx), ...]`` for `cross_val_path` to warm-start."""
        out = []
        for s in range(self.n_lanes):
            if self.lane_fold[s] >= 0 or self.cursor >= self.total_items:
                continue
            f, j = self._item(self.cursor)
            self.cursor += 1
            self.lane_fold[s] = f
            self.lane_lam[s] = j
            self.lane_left[s] = self.max_outer
            self.lane_eps[s] = 0
            self.lane_rec[s] = 0
            out.append((s, f, j))
        return out

    def dispatch_budget(self, block: int) -> int:
        """Outer iterations the next dispatch may run: capped by ``block``
        and by the smallest remaining per-item budget among active lanes
        (so no item ever exceeds its ``max_outer`` contract)."""
        act = self.active_slots()
        if len(act) == 0:
            raise RuntimeError("dispatch_budget with no active lanes")
        return int(min(int(block), int(self.lane_left[act].min())))

    # ------------------------------------------------------------ rounds
    def observe(self, kkts, gcounts, n_eps, it: int, tol: float
                ) -> RoundReport:
        """Charge one dispatch (``it`` outers) to every active lane and
        retire the finished ones.

        ``kkts/gcounts/n_eps`` are the full ``[n_lanes]`` host arrays from
        the sync; retirement = converged (kkt <= tol) OR budget exhausted.
        The per-fold bank advances to the retired item with the largest
        lambda index (the densest completed solution); the report tells the
        grid which slots to harvest and which bank entries to overwrite.
        """
        act = self.active_slots()
        rep = RoundReport(active=act, rec_before=self.lane_rec[act].copy())
        self.lane_left[act] -= int(it)
        self.lane_eps[act] += np.asarray(n_eps, np.int64)[act]
        self.lane_rec[act] += int(it)
        kkts = np.asarray(kkts)
        retired_mask = (kkts[act] <= tol) | (self.lane_left[act] <= 0)
        retired = act[retired_mask]
        rep.continuing = act[~retired_mask]
        best: Dict[int, Tuple[int, int]] = {}    # fold -> (lam_idx, slot)
        for s in retired:
            f, j = int(self.lane_fold[s]), int(self.lane_lam[s])
            rep.retired.append(Retirement(
                slot=int(s), fold=f, lam_idx=j,
                converged=bool(kkts[s] <= tol),
                n_epochs=int(self.lane_eps[s])))
            if j > int(self.bank_lam[f]) and j > best.get(f, (-1, -1))[0]:
                best[f] = (j, int(s))
        gcounts = np.asarray(gcounts)
        for f, (j, s) in sorted(best.items()):
            self.bank_lam[f] = j
            self.bank_gcount[f] = int(gcounts[s])
            rep.bank_updates.append((f, s, j))
        self.lane_fold[retired] = -1
        self.lane_lam[retired] = -1
        self.lane_eps[retired] = 0
        self.n_retired += len(retired)
        return rep

    # ------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Flat numpy snapshot (all scheduler state; checkpoint leaf set)."""
        return {
            "cursor": np.int64(self.cursor),
            "n_retired": np.int64(self.n_retired),
            "lane_fold": self.lane_fold.copy(),
            "lane_lam": self.lane_lam.copy(),
            "lane_left": self.lane_left.copy(),
            "lane_eps": self.lane_eps.copy(),
            "lane_rec": self.lane_rec.copy(),
            "bank_lam": self.bank_lam.copy(),
            "bank_gcount": self.bank_gcount.copy(),
        }

    def load_state(self, state: Dict[str, np.ndarray]):
        """Restore a `state_dict` snapshot (shapes must match this grid)."""
        for name in ("lane_fold", "lane_lam", "lane_left", "lane_eps",
                     "lane_rec"):
            arr = np.asarray(state[name], np.int64)
            if arr.shape != (self.n_lanes,):
                raise ValueError(f"scheduler state {name!r} has shape "
                                 f"{arr.shape}, expected ({self.n_lanes},)")
            setattr(self, name, arr.copy())
        for name in ("bank_lam", "bank_gcount"):
            arr = np.asarray(state[name], np.int64)
            if arr.shape != (self.n_folds,):
                raise ValueError(f"scheduler state {name!r} has shape "
                                 f"{arr.shape}, expected ({self.n_folds},)")
            setattr(self, name, arr.copy())
        self.cursor = int(state["cursor"])
        self.n_retired = int(state["n_retired"])
