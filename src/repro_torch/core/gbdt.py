"""Inference side of the GBDT forests, in the dense layout on a device.

A forest is a stack of complete binary trees of depth D (the layout of
``repro.core.gbdt.DenseForest``, which trains them):

    feature   : (T, 2^D - 1) int32    -- split feature per internal node
    threshold : (T, 2^D - 1) float32  -- split threshold (+inf = pass left)
    leaf      : (T, 2^D)     float32  -- leaf values (lr baked in)

Margins are float32 sums of the reached leaves plus the base score, as
the reference's jax/pallas backends compute them (its numpy traversal
sums in float64 and agrees to rounding).  Training is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gbdt_forest import ops as kops


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
