"""The tunable configuration space Theta (paper SII-B / SIII-C).

DIAL tunes two per-OSC Lustre client knobs that (a) are runtime-tunable
with near-immediate effect and (b) have workload-entangled optima:

    theta^1 = RPC window size   (osc.*.max_pages_per_rpc)
    theta^2 = RPCs in flight    (osc.*.max_rpcs_in_flight)

The discrete space below spans Lustre's practical range (64 KiB .. 4 MiB
windows, 1 .. 32 concurrent RPCs); the Lustre defaults (256 pages, 8) sit
mid-grid.  |Theta| = 24, which the tuner scores exhaustively each interval
— this full scan is what the batched GBDT inference kernel accelerates.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

WINDOW_PAGES = (16, 64, 256, 1024)
RPCS_IN_FLIGHT = (1, 2, 4, 8, 16, 32)

DEFAULT = (256, 8)  # Lustre defaults


@dataclasses.dataclass(frozen=True)
class ConfigSpace:
    """Discrete Theta with helpers for normalization and enumeration."""

    window_pages: tuple = WINDOW_PAGES
    rpcs_in_flight: tuple = RPCS_IN_FLIGHT

    def __len__(self) -> int:
        return len(self.window_pages) * len(self.rpcs_in_flight)

    def configs(self) -> list[tuple[int, int]]:
        """All theta = (window_pages, rpcs_in_flight), row-major."""
        return list(itertools.product(self.window_pages, self.rpcs_in_flight))

    def as_array(self) -> np.ndarray:
        """(|Theta|, 2) array of raw theta values."""
        return np.array(self.configs(), dtype=np.float64)

    def as_features(self) -> np.ndarray:
        """(|Theta|, 2) log2-scaled theta features fed to the GBDT.

        Both knobs are power-of-two grids; log scaling gives the trees
        evenly spaced split candidates.
        """
        return np.log2(self.as_array())

    def minmax_normalize(self, thetas: np.ndarray) -> np.ndarray:
        """MinMax-normalize a subset S of configurations (Algorithm 1 l.6).

        Normalization is over the *subset* S, exactly as in the paper: the
        regularizer then ranks surviving configs relative to one another.
        Degenerate spans (single distinct value) normalize to 0.
        """
        t = np.asarray(thetas, dtype=np.float64)
        lo = t.min(axis=0, keepdims=True)
        hi = t.max(axis=0, keepdims=True)
        span = np.where(hi - lo > 0, hi - lo, 1.0)
        return (t - lo) / span

    def index_of(self, theta: tuple[int, int]) -> int:
        return self.configs().index((int(theta[0]), int(theta[1])))


SPACE = ConfigSpace()
