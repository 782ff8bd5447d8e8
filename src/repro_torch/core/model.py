"""DIAL's learned models: f(θ, H_t) -> P(improvement > 1 + ε).

One :class:`DIALModel` bundles the read and write forests (separate
models per op, paper SIII-B).  :meth:`DIALModel.score_fleet` scores the
fleet's (interface x θ) rows of both ops in a single launch of the
paired-forest kernel.  Artifacts are the reference's: ``<prefix>.read.npz``,
``<prefix>.write.npz`` and an optional ``<prefix>.meta.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.gbdt import DenseForest
from repro_torch.kernels.gbdt_forest import ops as kops
from repro_torch.pfs.state import READ


def dataset_fingerprint(data: dict) -> dict:
    """Row counts and a content hash of a ``{'read': (X, y), 'write':
    (X, y)}`` training dict (the reference's), persisted with trained
    artifacts so evaluations can refuse a model trained on other data."""
    import hashlib

    h = hashlib.sha256()
    counts = {}
    for op_name in ("read", "write"):
        X, y = data[op_name]
        counts[op_name] = int(len(X))
        h.update(np.ascontiguousarray(np.asarray(X, dtype=np.float32)))
        h.update(np.ascontiguousarray(np.asarray(y, dtype=np.float64)))
    return {"rows": counts, "sha256": h.hexdigest()[:16]}


@dataclasses.dataclass
class DIALModel:
    read_forest: DenseForest
    write_forest: DenseForest
    space: ConfigSpace = SPACE
    k: int = 1  # history length (paper uses k=1)
    # provenance: trainer + dataset fingerprint, persisted by save/load
    train_meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.read_forest.device != self.write_forest.device:
            raise ValueError("DIALModel: read and write forests on "
                             f"{self.read_forest.device} and "
                             f"{self.write_forest.device}")
        self._fleet_predictor = None
        # bumped by update_forests: caches keyed on the model (the lab's
        # fused loops) see the new trees
        self._version = 0

    def update_forests(self, read_forest: DenseForest | None = None,
                       write_forest: DenseForest | None = None) -> None:
        """Swap retrained forests in place (the online-refit path).

        Drops the cached fleet predictor, which holds the old forests'
        paired tensors, so the next score is made with the new trees.
        """
        if read_forest is not None:
            self.read_forest = read_forest
        if write_forest is not None:
            self.write_forest = write_forest
        self._fleet_predictor = None
        self._version += 1

    @property
    def device(self) -> torch.device:
        return self.read_forest.device

    def forest(self, op: int) -> DenseForest:
        return self.read_forest if op == READ else self.write_forest

    def score_fleet(self, x_read: torch.Tensor, x_write: torch.Tensor):
        """float32 probabilities of mixed read/write row batches, both ops
        in one launch with a per-row forest selector."""
        if self._fleet_predictor is None:
            self._fleet_predictor = kops.make_fleet_predictor(
                self.read_forest, self.write_forest, self.device)
        return self._fleet_predictor(x_read, x_write)

    def predict_proba(self, op: int, x: torch.Tensor) -> torch.Tensor:
        """float32 probabilities of rows ``x`` under op ``op``'s forest."""
        return self.forest(op).predict_proba(x)

    def save(self, prefix: str) -> None:
        self.read_forest.save(prefix + ".read.npz")
        self.write_forest.save(prefix + ".write.npz")
        meta_path = prefix + ".meta.json"
        if self.train_meta:
            with open(meta_path, "w") as f:
                json.dump(self.train_meta, f, indent=2, default=str)
        elif os.path.exists(meta_path):
            # never leave another model's provenance beside these forests
            os.remove(meta_path)

    @staticmethod
    def load(prefix: str, device=None) -> "DIALModel":
        """Load the reference's artifacts onto ``device`` (None = CUDA)."""
        dev = resolve_device(device)
        meta = {}
        meta_path = prefix + ".meta.json"
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = {}
        return DIALModel(
            read_forest=DenseForest.load(prefix + ".read.npz", dev),
            write_forest=DenseForest.load(prefix + ".write.npz", dev),
            train_meta=meta)
