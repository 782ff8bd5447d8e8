"""GBDT training on the device (the learn layer).

``boost``
    grows a batch of :class:`~repro_torch.core.gbdt.DenseForest` level by
    level, each level's histograms in one launch of the hand-written
    ``tree_histogram`` kernel, so the read+write pair -- or a sweep of
    continuous hyperparameters -- trains together;
``online``
    fixed-capacity replay buffers, a throughput-drift trigger, and the
    refit policy that swaps retrained forests into a live model.
"""

from repro_torch.learn.boost import fit_forest, fit_forest_batch
from repro_torch.learn.online import (DriftDetector, OnlinePolicy,
                                      OnlineTrainer, ReplayBuffer)

__all__ = [
    "fit_forest",
    "fit_forest_batch",
    "ReplayBuffer",
    "DriftDetector",
    "OnlinePolicy",
    "OnlineTrainer",
]
