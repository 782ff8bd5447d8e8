"""Inference side of the GBDT forests, in the dense layout on a device.

A forest is a stack of complete binary trees of depth D (the layout of
``repro.core.gbdt.DenseForest``, which trains them):

    feature   : (T, 2^D - 1) int32    -- split feature per internal node
    threshold : (T, 2^D - 1) float32  -- split threshold (+inf = pass left)
    leaf      : (T, 2^D)     float32  -- leaf values (lr baked in)

Margins are float32 sums of the reached leaves plus the base score, as
the reference's jax/pallas backends compute them (its numpy traversal
sums in float64 and agrees to rounding).

Training (:mod:`repro_torch.learn.boost`) bins through
:func:`quantile_edges` / :func:`bin_codes`, host numpy copied from the
reference's ``repro/core/gbdt.py``: the port reproduces the numpy
trainer's splits only because both bin through the exact same code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gbdt_forest import ops as kops

# Split gains are rounded to this many decimals before the argmax so that
# mathematically equal candidates stay tied under any summation order;
# ties then break on (feature, bin) order, as in the reference trainers.
GAIN_DECIMALS = 9


def quantile_edges(X: np.ndarray, n_bins: int) -> list[np.ndarray]:
    """Per-feature quantile bin edges (deduplicated, possibly empty)."""
    X = np.asarray(X, dtype=np.float64)
    qs_grid = np.linspace(0, 1, n_bins + 1)[1:-1]
    return [np.unique(np.quantile(X[:, f], qs_grid))
            for f in range(X.shape[1])]


def bin_codes(X: np.ndarray, edges: list[np.ndarray]) -> np.ndarray:
    """Integer bin codes: ``code > b  <=>  x > edges[f][b]`` (side-right
    searchsorted, the raw-threshold-compatible binning semantics)."""
    X = np.asarray(X, dtype=np.float64)
    Xb = np.empty(X.shape, dtype=np.int16)
    for f, e in enumerate(edges):
        Xb[:, f] = np.searchsorted(e, X[:, f], side="right")
    return Xb


@dataclasses.dataclass
class GBDTParams:
    """Training hyperparameters (the reference's defaults)."""

    n_trees: int = 160
    max_depth: int = 5
    learning_rate: float = 0.1
    reg_lambda: float = 1.0
    min_gain: float = 1e-4
    min_child_hess: float = 1.0
    n_bins: int = 48
    subsample: float = 0.85
    seed: int = 0


@dataclasses.dataclass
class DenseForest:
    """An inference-ready forest whose arrays live on one device."""

    feature: torch.Tensor    # (T, 2^D - 1) int32
    threshold: torch.Tensor  # (T, 2^D - 1) float32
    leaf: torch.Tensor       # (T, 2^D) float32
    base_score: float
    depth: int
    n_features: int

    def __post_init__(self):
        t, n_internal = self.feature.shape
        if n_internal != 2 ** self.depth - 1 \
                or tuple(self.threshold.shape) != (t, n_internal) \
                or tuple(self.leaf.shape) != (t, 2 ** self.depth):
            raise ValueError("DenseForest: arrays do not form complete "
                             f"trees of depth {self.depth}")
        if self.feature.numel() and not (
                0 <= int(self.feature.min())
                and int(self.feature.max()) < self.n_features):
            raise ValueError("DenseForest: split feature out of range "
                             f"[0, {self.n_features})")

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def numpy_arrays(self):
        """``(feature, threshold, leaf)`` as host numpy arrays."""
        return (self.feature.cpu().numpy(), self.threshold.cpu().numpy(),
                self.leaf.cpu().numpy())

    def predict_margin(self, x: torch.Tensor) -> torch.Tensor:
        """(N,) float32 margins of (N, n_features) samples on the device."""
        return kops.forest_margin(x.to(torch.float32).contiguous(),
                                  self.feature, self.threshold, self.leaf,
                                  self.base_score, self.depth)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return kops.sigmoid32(self.predict_margin(x))

    def save(self, path: str) -> None:
        feature, threshold, leaf = self.numpy_arrays()
        np.savez_compressed(
            path, feature=feature, threshold=threshold, leaf=leaf,
            base_score=self.base_score, depth=self.depth,
            n_features=self.n_features)

    @staticmethod
    def load(path: str, device) -> "DenseForest":
        from repro_torch.convert import forest_from_numpy
        z = np.load(path)
        return forest_from_numpy(z["feature"], z["threshold"], z["leaf"],
                                 float(z["base_score"]), int(z["depth"]),
                                 int(z["n_features"]), device)
