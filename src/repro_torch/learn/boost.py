"""GBDT training on the device: a batch of forests grown level by level.

The port of ``repro/learn/boost.py``.  The exported
:class:`~repro_torch.core.gbdt.DenseForest` is a complete binary tree of
static depth D, so growth is level-synchronous and fixed-shape:

* every level is one multi-channel histogram reduction
  (:mod:`repro_torch.kernels.tree_histogram`: gradient / hessian per
  (node, feature, bin) cell) followed by dense cumsum/argmax gain math;
  levels d >= 1 reduce only left children from samples and take the
  right ones as ``parent - left`` (sibling subtraction);
* the depth loop is unrolled over the D levels, the tree loop is a
  Python loop carrying the margin (the reference's ``lax.scan``);
* a batch of forests (the read/write pair, or a sweep of continuous
  hyperparameters) is a leading tensor axis, so each level of the whole
  batch is one kernel launch -- the reference's ``vmap``.  Datasets are
  padded to a common shape with zero-weight rows and single-bin
  features.

Split selection replicates the numpy trainer
(``repro.core.gbdt.GBDTClassifier``) decision for decision: identical
quantile binning (:func:`repro_torch.core.gbdt.quantile_edges`, a copy
of the reference's), XGBoost gain, gains rounded to ``GAIN_DECIMALS``,
first-occurrence tie-breaking (lowest feature, then lowest bin),
pass-through and empty-leaf inheritance, and the same numpy subsample
stream.  The preparation (binning, padding, masks) is host numpy copied
from the reference.  Unlike the reference there is no histogram
strategy to choose: the kernel takes both precisions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.gbdt import (GAIN_DECIMALS, DenseForest, GBDTParams,
                                   bin_codes, quantile_edges)
from repro_torch.kernels.tree_histogram.ops import BinIndex, tree_histogram

_INT32_MAX = np.iinfo(np.int32).max
PRECISIONS = {"exact": torch.float64, "fast": torch.float32}


# ---------------------------------------------------------------------- #
# numpy-side preparation: binning, padding, subsample masks
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class BinnedDataset:
    """One dataset in the fixed-shape layout the trainer consumes.

    ``edges_pad`` is the per-feature edge table padded to ``n_bins - 1``
    columns with ``+inf``; ``bin_count[f]`` is the real number of bins
    (``len(edges[f]) + 1``), so valid split bins are ``b < bin_count - 1``.
    ``valid`` marks real rows (padding rows carry zero weight).
    """

    X: np.ndarray           # (n, F) float64 raw values
    Xb: np.ndarray          # (n, F) int32 bin codes
    edges_pad: np.ndarray   # (F, n_bins - 1) float64
    bin_count: np.ndarray   # (F,) int32
    y: np.ndarray           # (n,) float64
    valid: np.ndarray       # (n,) float64 1/0
    base: float             # log-odds base score
    n_features: int         # pre-padding feature count
    n_rows: int             # pre-padding row count


def bin_dataset(X: np.ndarray, y: np.ndarray, n_bins: int) -> BinnedDataset:
    """Quantile-bin one dataset (the numpy trainer's exact binning)."""
    X = np.asarray(X, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, n_feat = X.shape
    edges = quantile_edges(X, n_bins)
    Xb = bin_codes(X, edges).astype(np.int32)
    edges_pad = np.full((n_feat, n_bins - 1), np.inf)
    for f, e in enumerate(edges):
        edges_pad[f, :len(e)] = e
    bin_count = np.array([len(e) + 1 for e in edges], dtype=np.int32)
    pos = y.mean()
    base = float(np.log(max(pos, 1e-6) / max(1 - pos, 1e-6)))
    return BinnedDataset(X=X, Xb=Xb, edges_pad=edges_pad, bin_count=bin_count,
                         y=y, valid=np.ones(n), base=base,
                         n_features=n_feat, n_rows=n)


def pad_dataset(ds: BinnedDataset, n: int, n_feat: int) -> BinnedDataset:
    """Pad to ``(n, n_feat)``: extra rows are zero-weight, extra features
    are single-bin (never splittable), so padding changes nothing."""
    dn, dF = ds.Xb.shape
    if (dn, dF) == (n, n_feat):
        return ds
    X = np.zeros((n, n_feat))
    X[:dn, :dF] = ds.X
    Xb = np.zeros((n, n_feat), dtype=np.int32)
    Xb[:dn, :dF] = ds.Xb
    edges_pad = np.full((n_feat, ds.edges_pad.shape[1]), np.inf)
    edges_pad[:dF] = ds.edges_pad
    bin_count = np.ones(n_feat, dtype=np.int32)
    bin_count[:dF] = ds.bin_count
    y = np.zeros(n)
    y[:dn] = ds.y
    valid = np.zeros(n)
    valid[:dn] = ds.valid
    return dataclasses.replace(ds, X=X, Xb=Xb, edges_pad=edges_pad,
                               bin_count=bin_count, y=y, valid=valid)


def subsample_masks(params: GBDTParams, n_rows: int, n: int) -> np.ndarray:
    """The numpy trainer's per-tree subsample stream, padded to ``n``
    columns (padding rows always masked out)."""
    masks = np.zeros((params.n_trees, n))
    if params.subsample < 1.0:
        rng = np.random.default_rng(params.seed)
        masks[:, :n_rows] = (rng.random((params.n_trees, n_rows))
                             < params.subsample)
    else:
        masks[:, :n_rows] = 1.0
    return masks


def prepare_batch(datasets, plist) -> tuple[list, list]:
    """Bin each ``(X, y)`` with its params' ``n_bins`` and pad all to a
    common shape; returns ``(binned, padded)`` datasets."""
    binned = [bin_dataset(X, y, p.n_bins)
              for (X, y), p in zip(datasets, plist)]
    n = max(ds.n_rows for ds in binned)
    n_feat = max(ds.n_features for ds in binned)
    return binned, [pad_dataset(ds, n, n_feat) for ds in binned]


# ---------------------------------------------------------------------- #
# the trainer
# ---------------------------------------------------------------------- #
def training_index(Xb: torch.Tensor, valid: torch.Tensor,
                   min_child_hess: torch.Tensor, n_bins: int):
    """The trainer's :class:`BinIndex` over ``(B, n, F)`` codes, and the
    ``(B,)`` feature whose bins give each forest's node totals.

    A feature whose real rows (``valid`` ``(B, n)`` bool) all sit in
    one bin can never split while ``min_child_hess > 0``: one side of
    every cut holds no hessian.  Padding features and constant columns
    are such features, and each would cost the kernel one full-length
    segment at every level, so they are not walked.  The first walked
    feature (feature 0 if none is) is read for the node totals.
    """
    big = torch.iinfo(torch.int32).max
    lo = torch.where(valid[:, :, None], Xb, big).amin(1)
    hi = torch.where(valid[:, :, None], Xb, -1).amax(1)
    walk = (hi > lo) | (min_child_hess <= 0)[:, None]        # (B, F)
    f_tot = torch.argmax(walk.to(torch.int32), dim=1)       # first True
    walk[torch.arange(len(walk), device=walk.device), f_tot] = True
    return BinIndex.build(Xb, n_bins, walk), f_tot


def grow_forest(X, Xb, edges_pad, bin_count, y, valid, masks, base, lr, lam,
                min_gain, min_child_hess, *, max_depth: int,
                precision: str):
    """Grow a batch of B forests on the tensors' device.

    Shapes: ``X (B, n, F)`` float64 raw values, ``Xb (B, n, F)`` int32
    bin codes, ``edges_pad (B, F, NB-1)`` float64,
    ``bin_count (B, F)``, ``y/valid (B, n)``, ``masks (B, T, n)`` bool;
    ``base`` and the four hyperparameters are ``(B,)`` (one per forest).
    Returns ``(feature (B, T, 2^D-1) int32, threshold (B, T, 2^D-1)
    float32, leaf (B, T, 2^D) float32)``.

    ``precision="exact"`` runs in float64 and replicates the numpy
    trainer split for split, including its float32-threshold partitions
    (below); ``"fast"`` runs in float32 with one partition -- forests of
    equal quality (AUC parity), the refit configuration.  Nothing in
    the loops reads the device from the host.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    fast = precision == "fast"
    dt = PRECISIONS[precision]
    dev = Xb.device
    bsz, n, n_feat = Xb.shape
    n_bins = edges_pad.shape[2] + 1
    n_trees = masks.shape[1]
    n_internal = 2 ** max_depth - 1
    n_leaves = 2 ** max_depth

    edges = edges_pad.to(dt)
    y, valid = y.to(dt), valid.to(dt)
    col = lambda v: v.to(dt)[:, None]                       # (B, 1)
    lr, lam, min_gain = col(lr), col(lam), col(min_gain)
    lam4, mch4 = lam[:, :, None, None], col(min_child_hess)[:, :, None, None]
    index, f_tot = training_index(Xb, valid > 0, min_child_hess, n_bins)
    split_ok = (torch.arange(n_bins - 1, device=dev)[None, None, :]
                < (bin_count.to(dev)[:, :, None] - 1))      # (B, F, NB-1)
    leaf_j = torch.arange(n_leaves, device=dev)
    batch = torch.arange(bsz, device=dev)[:, None]
    root = torch.zeros((bsz, n), dtype=torch.int32, device=dev)

    margin = col(base).expand(bsz, n).contiguous()
    features, thresholds, leaves = [], [], []
    for t in range(n_trees):
        mask = masks[:, t].to(dt)
        prob = 1.0 / (1.0 + torch.exp(-torch.clamp(margin, -30.0, 30.0)))
        g = (prob - y) * mask
        h = torch.clamp_min(prob * (1.0 - prob), 1e-6) * mask
        gh2 = torch.stack([g, h], dim=1)                    # (B, 2, n)

        node = torch.zeros((bsz, n), dtype=torch.int64, device=dev)
        mnode = node                                        # margin partition
        feat_parts, thr_parts = [], []
        hist = vals = None
        for d in range(max_depth):
            n_here = 1 << d
            level_start = n_here - 1
            if d == 0:
                hist = tree_histogram(gh2, index, root, 1)
            else:
                half = n_here // 2
                loc = node - level_start                    # in [0, n_here)
                left_ids = torch.where(loc % 2 == 0, loc // 2, half)
                left = tree_histogram(gh2, index, left_ids.to(torch.int32),
                                      half)
                hist = torch.stack([left, hist - left], dim=3).reshape(
                    bsz, 2, n_here, n_feat, n_bins)
            gh, hh = hist[:, 0], hist[:, 1]                 # (B, n_here, F, NB)
            GL = torch.cumsum(gh, dim=-1)[..., :-1]
            HL = torch.cumsum(hh, dim=-1)[..., :-1]
            G = gh.sum(-1, keepdim=True)
            H = hh.sum(-1, keepdim=True)
            GR, HR = G - GL, H - HL
            gain = 0.5 * (GL ** 2 / (HL + lam4) + GR ** 2 / (HR + lam4)
                          - G ** 2 / (H + lam4))
            ok = split_ok[:, None] & (HL >= mch4) & (HR >= mch4)
            gain = torch.where(ok, gain, -torch.inf)
            if not fast:
                gain = torch.round(gain, decimals=GAIN_DECIMALS)

            # first-occurrence argmax over the flattened (F, NB-1) grid ==
            # the numpy trainer's lowest-feature-then-lowest-bin tie-break
            flat = gain.reshape(bsz, n_here, -1)
            best = torch.argmax(flat, dim=2)                # (B, n_here)
            best_gain = torch.gather(flat, 2, best[..., None])[..., 0]
            f_best = best // (n_bins - 1)
            b_best = best % (n_bins - 1)
            has_split = best_gain > min_gain                # -inf never passes

            # Newton value of every level node (pass-through spine values):
            # any one walked feature's bins sum to the node totals
            tot = hist[batch[:, 0], :, :, f_tot].sum(-1)    # (B, 2, n_here)
            vals = -lr * tot[:, 0] / (tot[:, 1] + lam)      # (B, n_here)

            feat_level = torch.where(has_split, f_best, 0)
            edge_val = edges[batch, f_best, b_best]
            feat_parts.append(feat_level)
            thr_parts.append(torch.where(has_split, edge_val, torch.inf))

            def descend(ptr, cut_level, x):
                """Children of ``ptr``: right where ``x[f] > cut``."""
                lc = ptr - level_start
                f_node = torch.gather(feat_level, 1, lc)
                cut = torch.gather(cut_level, 1, lc)
                xf = torch.gather(x, 2, f_node[..., None])[..., 0]
                return 2 * ptr + 1 + (xf > cut).to(torch.int64)

            if fast:
                # one partition: code > b  <=>  raw x > threshold
                node = mnode = descend(
                    node, torch.where(has_split, b_best, _INT32_MAX),
                    index.bins)
            else:
                # The numpy trainer keeps thresholds in float32.  It builds
                # (histograms, leaves) on code > searchsorted(edges,
                # float32(thr)), and updates margins on raw x >
                # float32(thr).  Where float32 rounding moves the threshold
                # across an edge, or onto a sample's value, the two differ
                # from each other and from code > b: `node` follows the
                # build partition, `mnode` the raw one, both exactly.
                thr32 = edge_val.to(torch.float32).to(dt)
                below = (edges[batch, f_best] < thr32[..., None]).sum(-1)
                node = descend(node, torch.where(has_split, below,
                                                 _INT32_MAX), index.bins)
                mnode = descend(mnode, torch.where(has_split, thr32,
                                                   torch.inf), X)

        # leaves: Newton where occupied, direct-parent value where empty;
        # per-leaf sums are one dense (2^D, n) one-hot product
        sel = ((node - n_internal)[:, None, :]
               == leaf_j[None, :, None]).to(dt)             # (B, 2^D, n)
        sums = torch.bmm(sel, torch.stack([g, h, valid], dim=2))
        newton = -lr * sums[..., 0] / (sums[..., 1] + lam)
        leaf = torch.where(sums[..., 2] > 0, newton, vals[:, leaf_j // 2])
        margin = margin + torch.gather(leaf, 1, mnode - n_internal)
        features.append(torch.cat(feat_parts, dim=1))
        thresholds.append(torch.cat(thr_parts, dim=1))
        leaves.append(leaf)

    return (torch.stack(features, dim=1).to(torch.int32),
            torch.stack(thresholds, dim=1).to(torch.float32),
            torch.stack(leaves, dim=1).to(torch.float32))


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #
def fit_forest(X: np.ndarray, y: np.ndarray,
               params: GBDTParams | None = None, precision: str = "exact",
               device=None) -> DenseForest:
    """Train one forest on ``device`` (None = CUDA) -- the counterpart
    of ``GBDTClassifier(params).fit(X, y).forest``."""
    return fit_forest_batch([(X, y)], params or GBDTParams(),
                            precision=precision, device=device)[0]


def fit_forest_batch(datasets, params: GBDTParams | list | None = None,
                     precision: str = "exact",
                     device=None) -> list[DenseForest]:
    """Train B forests together, each level of all B in one launch.

    ``datasets`` is a list of ``(X, y)`` pairs (row/feature counts may
    differ -- they are padded to a common shape with inert rows and
    features).  ``params`` is one :class:`GBDTParams` for all forests or
    a per-forest list; the continuous hyperparameters
    (``learning_rate``, ``reg_lambda``, ``min_gain``, ``min_child_hess``)
    may vary per forest, the structural ones (``n_trees``,
    ``max_depth``, ``n_bins``) must be shared.  The forests come back on
    ``device`` (None = CUDA).
    """
    dev = resolve_device(device)
    if params is None:
        params = GBDTParams()
    plist = (list(params) if isinstance(params, (list, tuple))
             else [params] * len(datasets))
    if len(plist) != len(datasets):
        raise ValueError("one GBDTParams per dataset (or a single shared)")
    p0 = plist[0]
    for p in plist[1:]:
        if (p.n_trees, p.max_depth, p.n_bins) != (p0.n_trees, p0.max_depth,
                                                  p0.n_bins):
            raise ValueError("structural params (n_trees, max_depth, "
                             "n_bins) must be shared across a batch")

    binned, padded = prepare_batch(datasets, plist)
    n = padded[0].Xb.shape[0]
    masks = np.stack([subsample_masks(p, ds.n_rows, n)
                      for ds, p in zip(binned, plist)]) > 0
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    stack = lambda attr: to(np.stack([getattr(ds, attr) for ds in padded]))
    hyper = to(np.array([(p.learning_rate, p.reg_lambda, p.min_gain,
                          p.min_child_hess) for p in plist], dtype=float))
    features, thresholds, leaves = grow_forest(
        stack("X"), stack("Xb"), stack("edges_pad"), stack("bin_count"), stack("y"),
        stack("valid"), to(masks), to(np.array([ds.base for ds in binned])),
        *hyper.unbind(1), max_depth=p0.max_depth, precision=precision)
    return [DenseForest(feature=features[i], threshold=thresholds[i],
                        leaf=leaves[i], base_score=binned[i].base,
                        depth=p0.max_depth, n_features=binned[i].n_features)
            for i in range(len(binned))]
