"""Continual learning: replay buffers, drift detection, periodic refit.

The port of ``repro/learn/online.py``.  The buffers and the detector are
host numpy, copied; a refit trains the forests of the ops that have
enough samples in one :func:`~repro_torch.learn.boost.fit_forest_batch`
on the model's device and swaps them in through
:meth:`DIALModel.update_forests`, so every open reference to the model
(e.g. a running :class:`~repro_torch.core.fleet.FleetAgent`) scores with
the new forests from its next tick on.

``ReplayBuffer``
    fixed-capacity ring of (feature row, label) pairs per op;
``DriftDetector``
    a fast/slow throughput EMA pair; when the fast estimate falls below
    ``drop_frac`` of the slow one the world has shifted under the model;
``OnlineTrainer``
    owns the buffers, the detector and the refit schedule.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.metrics import feature_dim
from repro_torch.learn.boost import fit_forest_batch
from repro_torch.pfs.state import READ, WRITE


class ReplayBuffer:
    """Fixed-capacity FIFO ring of (feature row, label) samples."""

    def __init__(self, capacity: int, dim: int):
        self.capacity = int(capacity)
        self.X = np.zeros((self.capacity, dim), dtype=np.float32)
        self.y = np.zeros(self.capacity)
        self._pos = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add(self, X: np.ndarray, y: np.ndarray) -> None:
        """Append rows, overwriting the oldest once full."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float32))
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        if len(X) >= self.capacity:           # keep the newest tail
            X, y = X[-self.capacity:], y[-self.capacity:]
        n = len(X)
        end = min(self._pos + n, self.capacity)
        k = end - self._pos
        self.X[self._pos:end] = X[:k]
        self.y[self._pos:end] = y[:k]
        if k < n:                              # wrap around
            self.X[:n - k] = X[k:]
            self.y[:n - k] = y[k:]
        self._pos = (self._pos + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def dataset(self) -> tuple[np.ndarray, np.ndarray]:
        """Copy of the live contents (order is immaterial to the GBDT)."""
        return self.X[:self._size].copy(), self.y[:self._size].copy()


class DriftDetector:
    """Throughput drift as a fast/slow EMA divergence.

    ``update`` folds one interval's throughput into both EMAs and
    returns True when the fast estimate sits below ``drop_frac`` of the
    slow one (after ``warmup`` intervals).
    """

    def __init__(self, fast: float = 0.5, slow: float = 0.08,
                 drop_frac: float = 0.75, warmup: int = 6):
        self.alpha_fast = fast
        self.alpha_slow = slow
        self.drop_frac = drop_frac
        self.warmup = warmup
        self.reset()

    def reset(self, level: float | None = None) -> None:
        self._fast = self._slow = level
        self._n = 0

    def update(self, tput: float) -> bool:
        tput = float(tput)
        if self._fast is None:
            self._fast = self._slow = tput
        else:
            self._fast += self.alpha_fast * (tput - self._fast)
            self._slow += self.alpha_slow * (tput - self._slow)
        self._n += 1
        return (self._n > self.warmup and self._slow > 0
                and self._fast < self.drop_frac * self._slow)


@dataclasses.dataclass
class OnlinePolicy:
    """When and how the online trainer refits."""

    refit_every: int = 0        # periodic refit cadence in intervals; 0 = off
    min_samples: int = 48       # per-op floor before an op's forest refits
    capacity: int = 4096        # replay-buffer rows per op
    cooldown: int = 6           # min intervals between refits
    explore_eps: float = 0.15   # lab-side epsilon-greedy exploration rate
    drift_drop_frac: float = 0.75
    drift_fast: float = 0.5
    drift_slow: float = 0.08
    drift_warmup: int = 6


class OnlineTrainer:
    """Buffers + drift trigger + refit schedule around a live model.

    Call :meth:`observe` with labeled rows as they materialize and
    :meth:`step` once per tuning interval with that interval's
    throughput; ``step`` returns a refit record (or None) after swapping
    retrained forests into the model in place.  Refits train in float32
    (``precision="fast"``): a live run needs refit latency, not bit
    parity with the numpy trainer.
    """

    def __init__(self, model, gbdt_params: GBDTParams | None = None,
                 policy: OnlinePolicy | None = None):
        self.model = model
        self.params = gbdt_params or GBDTParams(n_trees=40, max_depth=5)
        self.policy = policy if policy is not None else OnlinePolicy()
        self.buffers = {op: ReplayBuffer(self.policy.capacity,
                                         feature_dim(op, model.k))
                        for op in (READ, WRITE)}
        self.detector = DriftDetector(fast=self.policy.drift_fast,
                                      slow=self.policy.drift_slow,
                                      drop_frac=self.policy.drift_drop_frac,
                                      warmup=self.policy.drift_warmup)
        self._interval = 0
        # periodic cadence and cooldown both count from the run start, so
        # the first refit cannot fire on a handful of warmup samples
        self._last_refit = 0
        self.refits: list[dict] = []

    def observe(self, op: int, X: np.ndarray, y: np.ndarray) -> None:
        if len(np.atleast_1d(y)):
            self.buffers[op].add(X, y)

    def seed(self, data: dict) -> None:
        """Warm-start the buffers from campaign data
        (``{'read': (X, y), 'write': (X, y)}``)."""
        for name, op in (("read", READ), ("write", WRITE)):
            X, y = data[name]
            if len(X):
                self.buffers[op].add(X, y)

    def step(self, tput: float) -> dict | None:
        """One interval heartbeat: update drift, maybe refit."""
        self._interval += 1
        drifted = self.detector.update(tput)
        due = (self.policy.refit_every > 0
               and self._interval - self._last_refit
               >= self.policy.refit_every)
        cooled = self._interval - self._last_refit >= self.policy.cooldown
        if not ((drifted or due) and cooled):
            return None
        ops = [op for op in (READ, WRITE)
               if len(self.buffers[op]) >= self.policy.min_samples]
        if not ops:
            return None
        return self._refit(ops, "drift" if drifted else "periodic", tput)

    def _refit(self, ops: list[int], reason: str, tput: float) -> dict:
        datasets = [self.buffers[op].dataset() for op in ops]
        forests = fit_forest_batch(datasets, self.params,
                                   precision="fast",
                                   device=self.model.device)
        kw = {("read_forest" if op == READ else "write_forest"): f
              for op, f in zip(ops, forests)}
        self.model.update_forests(**kw)
        self._last_refit = self._interval
        self.detector.reset(tput)   # the regime the new model trained on
        rec = {"interval": self._interval, "reason": reason,
               "ops": ["read" if op == READ else "write" for op in ops],
               "samples": {("read" if op == READ else "write"):
                           len(self.buffers[op]) for op in ops}}
        self.refits.append(rec)
        return rec
