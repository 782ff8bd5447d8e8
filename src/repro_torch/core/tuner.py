"""Conditional Score Greedy (paper Algorithm 1), batched on the device.

For each interface, given f(θ, H_t) over Θ:

  1. keep the configurations whose probability exceeds τ (strictly);
  2. MinMax-normalize the survivors;
  3. score them with the regularizer that prefers larger θ:
     WriteScore = f * (1 + β Σθ_norm),
     ReadScore  = f * (1 + α θ1_norm) + θ2_norm;
  4. take the first maximum; with no survivor keep the current θ.

The same masked reductions as the reference's ``score_greedy_arrays``
(``repro/core/tuner.py``), on tensors: row ``i`` equals the scalar
Algorithm 1 on ``probs[i]``, with the same first-max tie break.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.pfs.state import F64, WRITE


@dataclasses.dataclass(frozen=True)
class TunerParams:
    tau: float = 0.8      # probability threshold (paper SIII-C)
    alpha: float = 0.3    # read regularizer weight on theta^1 (window)
    beta: float = 0.25    # write regularizer weight on sum(theta)


@dataclasses.dataclass
class TuneDecision:
    """Algorithm 1's outcome for one interface (host values)."""

    theta: tuple[int, int]
    changed: bool
    n_candidates: int
    probs: torch.Tensor   # (|Θ|,) f(θ, H_t) over the whole space
    score: float


@dataclasses.dataclass
class FleetDecisions:
    """Algorithm 1 outcomes for a batch of interfaces (row-aligned)."""

    theta: torch.Tensor         # (m, 2) int64 chosen configuration
    changed: torch.Tensor       # (m,) bool
    n_candidates: torch.Tensor  # (m,) int64, how many configs cleared τ
    score: torch.Tensor         # (m,) float64 winning score (0 if none)
    probs: torch.Tensor         # (m, |Θ|) float64 f(θ, H_t)

    def __len__(self) -> int:
        return self.theta.shape[0]

    def to(self, device) -> "FleetDecisions":
        return FleetDecisions(**{f.name: getattr(self, f.name).to(device)
                                 for f in dataclasses.fields(self)})

    def one(self, i: int) -> TuneDecision:
        """Row ``i`` as a :class:`TuneDecision`."""
        return TuneDecision(
            theta=(int(self.theta[i, 0]), int(self.theta[i, 1])),
            changed=bool(self.changed[i]),
            n_candidates=int(self.n_candidates[i]),
            probs=self.probs[i], score=float(self.score[i]))


_GRIDS: dict = {}


def theta_grid(space: ConfigSpace, device) -> torch.Tensor:
    """``space.as_array()`` as a float64 tensor on ``device``, made once
    a (space, device): a captured interval may not copy from the host."""
    key = (space, torch.device(device))
    grid = _GRIDS.get(key)
    if grid is None:
        grid = _GRIDS[key] = torch.as_tensor(space.as_array(), device=device)
    return grid


def conditional_score_greedy_batch(
    probs: torch.Tensor,
    ops: torch.Tensor,
    current: torch.Tensor,
    space: ConfigSpace = SPACE,
    params: TunerParams | None = None,
) -> FleetDecisions:
    """Algorithm 1 over ``m`` interfaces at once.

    ``probs`` is (m, |Θ|) in ``space.configs()`` order, ``ops`` (m,) op
    codes, ``current`` (m, 2) integer θ.  Rows without a survivor carry
    inf/nan in masked lanes, which the keep mask discards.  Nothing here
    reads the device from the host, so it runs inside a CUDA graph.
    """
    params = params if params is not None else TunerParams()
    probs = probs.to(F64)
    inf = float("inf")
    thetas = theta_grid(space, probs.device)           # (M, 2)
    keep = probs > params.tau                          # (m, M)   line 4
    any_keep = keep.any(dim=1)

    # MinMax over each row's surviving subset (line 6), masked extrema
    t3 = thetas[None, :, :]                            # (1, M, 2)
    lo = torch.where(keep[:, :, None], t3, inf).amin(dim=1)
    hi = torch.where(keep[:, :, None], t3, -inf).amax(dim=1)
    span = torch.where(hi - lo > 0, hi - lo, 1.0)
    norm = (t3 - lo[:, None, :]) / span[:, None, :]    # (m, M, 2)

    w_scores = probs * (1.0 + params.beta * norm.sum(dim=2))
    r_scores = probs * (1.0 + params.alpha * norm[:, :, 0]) + norm[:, :, 1]
    scores = torch.where((ops == WRITE)[:, None], w_scores, r_scores)
    scores = torch.where(keep, scores, -inf)

    j = torch.argmax(scores, dim=1)                    # first max
    cur64 = current.to(torch.int64)
    theta = torch.where(any_keep[:, None], thetas[j].to(torch.int64), cur64)
    return FleetDecisions(
        theta=theta,
        changed=any_keep & (theta != cur64).any(dim=1),
        n_candidates=keep.sum(dim=1) * any_keep,
        score=torch.where(any_keep, scores.gather(1, j[:, None])[:, 0], 0.0),
        probs=probs)
