"""Offline data collection and training on the batch path.

The port of the reference's ``repro/lab/campaign.py``.  The paper's
SIV-A recipe (:func:`repro_torch.core.dataset.collect`) probes a grid of
filebench-style cells every 0.5 s while exploring random θ′ and labels
each transition with ``1[tput_{t+1}/tput_t > 1 + ε]``.  A campaign
builds one tiny scenario per cell -- 2 clients x 1 OST: a measurement
stream plus an optional noisy-neighbour stream on its own client --
stacks the whole grid into one batch (one fleet on the device) and
advances every cell's interval together.  Exploration, labeling and
feature assembly run as array programs over the batch (the same
``fleet_feature_matrix`` the fleet agent scores at inference).

Campaigns end in **versioned model artifacts**, in the reference's
format: ``models/lab/vNNN/`` holding the two forests
(``dial.read.npz`` / ``dial.write.npz``), a ``manifest.json`` (config,
sample counts, label rates, training provenance) and a ``LATEST``
pointer, so a campaign saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.config_space import SPACE, ConfigSpace
from repro_torch.core.dataset import EPS_IMPROVE, train_models
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.metrics import (feature_dim, fleet_feature_matrix,
                                      snapshot_all)
from repro_torch.core.model import DIALModel
from repro_torch.lab.batch import BatchEngine, BatchPort, stack_scenarios
from repro_torch.lab.scenarios import ScenarioSpec, build
from repro_torch.pfs.state import READ, WRITE
from repro_torch.pfs.workloads import Workload


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """The measurement-cell grid (paper: single streams, seq/rand x
    8K/1M/16M; thread counts extend the concurrency axis as in
    ``core/dataset``)."""

    req_sizes: tuple = (8 * 1024, 64 * 1024, 1 * 2**20, 16 * 2**20)
    patterns: tuple = (0.0, 0.9, 1.0)
    threads: tuple = (1, 4, 16, 32)


SMOKE_GRID = CellGrid(req_sizes=(64 * 1024, 4 * 2**20),
                      patterns=(0.0, 1.0), threads=(1, 8))


def smoke_campaign() -> tuple["CampaignConfig", GBDTParams]:
    """The one CI-sized campaign every smoke entry point shares (the
    CLI's ``campaign --smoke`` and ``evaluate``'s auto-trained fallback
    stay the same model grade)."""
    return (CampaignConfig(seconds=15.0, reps=1, grid=SMOKE_GRID),
            GBDTParams(n_trees=40, max_depth=5))


@dataclasses.dataclass
class CampaignConfig:
    seconds: float = 60.0
    interval: float = 0.5
    reps: int = 2                      # grid replicas (exploration diversity)
    k: int = 1
    min_volume_bytes: float = 64 * 1024
    contention_frac: float = 0.25      # cells that get a live noisy neighbour
    noise_rate: float = 1.2e9          # neighbour per-thread issue rate [B/s]
    seed: int = 0
    grid: CellGrid = dataclasses.field(default_factory=CellGrid)


def _cell_specs(cfg: CampaignConfig):
    """One 2-client x 1-OST ScenarioSpec per (cell, rep); returns the
    specs plus the per-element op codes.

    Every element has the same structure (2 workload rows, 1 stripe
    entry each, disjoint clients -> a single wave), so the whole grid
    stacks into one batch.  The neighbour row rides on its *own* client
    and is disabled by ``thread_rate=0`` in uncontended cells.
    """
    rng = np.random.default_rng(cfg.seed)
    cells = list(itertools.product((READ, WRITE), cfg.grid.patterns,
                                   cfg.grid.req_sizes, cfg.grid.threads))
    specs, ops = [], []
    for rep in range(cfg.reps):
        for i, (op, rnd, req, thr) in enumerate(cells):
            noisy = rng.random() < cfg.contention_frac
            measure = Workload(client=0, op=op, req_size=float(req),
                               randomness=float(rnd), n_threads=int(thr),
                               osts=(0,), name=f"cell{i}")
            noise = Workload(client=1, op=READ, req_size=1 * 2**20,
                             randomness=0.3, n_threads=4, osts=(0,),
                             thread_rate=cfg.noise_rate if noisy else 0.0,
                             name="noise")
            specs.append(ScenarioSpec(
                name=f"campaign_cell{i}_rep{rep}", n_clients=2, n_osts=1,
                workloads=(measure, noise), seed=cfg.seed * 1000 + rep))
            ops.append(op)
    return specs, np.asarray(ops, dtype=np.int64)


def collect_batch(cfg: CampaignConfig = CampaignConfig(),
                  space: ConfigSpace = SPACE, device=None) -> dict:
    """The collection sweep on the batch path, on ``device`` (``None``:
    the CUDA card).

    The explore/label alternation of
    :func:`repro_torch.core.dataset.collect` -- observe H_t under the
    held θ, apply a random θ′, label one interval later -- with every
    interval one :class:`~repro_torch.lab.batch.BatchEngine` interval
    over all cells.  The per-cell bookkeeping and the random draws stay
    on the host, in the reference's order.  Returns ``{'read': (X, y),
    'write': (X, y)}`` (X float32, y float64).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    specs, ops = _cell_specs(cfg)
    batch = stack_scenarios([build(s) for s in specs], device=dev)
    n_cells = len(batch)
    # measurement interface = (client 0, OST 0) = local OSC 0 per element
    cols = np.arange(n_cells, dtype=np.int64) * batch.n_osc
    port = BatchPort(batch, cols=cols)

    steps = max(int(round(cfg.interval / batch.params.tick)), 1)
    n_intervals = int(round(cfg.seconds / cfg.interval))
    engine = BatchEngine(batch.params, batch.fleet, steps)

    theta_feats = torch.as_tensor(space.as_features(), device=dev)
    configs = space.configs()
    m = len(configs)
    is_read = ops == READ

    prev = port.probe_all()
    hist: list = []
    pend_active = np.zeros(n_cells, dtype=bool)
    pend_tput = np.zeros(n_cells)
    pend_feats = {READ: np.zeros((n_cells, feature_dim(READ, cfg.k)),
                                 dtype=np.float32),
                  WRITE: np.zeros((n_cells, feature_dim(WRITE, cfg.k)),
                                  dtype=np.float32)}
    Xs = {READ: [], WRITE: []}
    ys = {READ: [], WRITE: []}

    for it in range(n_intervals):
        sched = batch.schedule(it * steps, steps).to(dev)
        batch.state, batch.wstate = engine.run_interval(
            batch.table, batch.state, batch.wstate, sched)
        cur = port.probe_all()
        snap = snapshot_all(prev, cur)
        prev = cur
        hist.append(snap)
        hist = hist[-(cfg.k + 1):]

        read_vol, write_vol, read_tp, write_tp = (
            a.cpu().numpy() for a in (snap.read_volume, snap.write_volume,
                                      snap.read[:, 0], snap.write[:, 0]))
        vol = np.where(is_read, read_vol, write_vol)
        tput = np.where(is_read, read_tp, write_tp)

        # finalize last interval's exploration with this interval's label
        was_pending = pend_active.copy()
        label_ok = (was_pending & (pend_tput > 0)
                    & (vol >= cfg.min_volume_bytes))
        for op in (READ, WRITE):
            sel = label_ok & (ops == op)
            if sel.any():
                Xs[op].append(pend_feats[op][sel].copy())
                ys[op].append((tput[sel] / pend_tput[sel]
                               > 1.0 + EPS_IMPROVE).astype(float))
        pend_active[:] = False

        # explore on alternating intervals (cells that just labeled rest
        # one interval so H_t reflects a steady state under the new θ)
        if len(hist) < cfg.k + 1:
            continue
        ready = (~was_pending) & (vol >= cfg.min_volume_bytes)
        rows = np.nonzero(ready)[0]
        if rows.size == 0:
            continue
        j = rng.integers(m, size=rows.size)
        for op in (READ, WRITE):
            sel = ops[rows] == op
            r_op = rows[sel]
            if r_op.size == 0:
                continue
            F = fleet_feature_matrix(hist, op, torch.as_tensor(
                r_op, device=dev), theta_feats).cpu().numpy()
            pend_feats[op][r_op] = F[np.arange(r_op.size) * m + j[sel]]
        theta = np.asarray([configs[x] for x in j], dtype=np.int64)
        port.set_knobs_many(cols[rows], theta[:, 0], theta[:, 1])
        pend_tput[rows] = tput[rows]
        pend_active[rows] = True

    def _cat(op):
        if not Xs[op]:
            dim = feature_dim(op, cfg.k)
            return (np.zeros((0, dim), dtype=np.float32), np.zeros(0))
        return (np.concatenate(Xs[op]).astype(np.float32),
                np.concatenate(ys[op]))

    return {"read": _cat(READ), "write": _cat(WRITE)}


# ---------------------------------------------------------------------- #
# versioned model artifacts
# ---------------------------------------------------------------------- #
_VERSION_RE = re.compile(r"^v(\d{3,})$")


def latest_version(root: str) -> str | None:
    """Resolve the newest ``vNNN`` directory under ``root`` (the LATEST
    pointer when present, else the highest version on disk)."""
    pointer = os.path.join(root, "LATEST")
    if os.path.exists(pointer):
        with open(pointer) as f:
            v = f.read().strip()
        if os.path.isdir(os.path.join(root, v)):
            return v
    if not os.path.isdir(root):
        return None
    versions = sorted((v for v in os.listdir(root) if _VERSION_RE.match(v)),
                      key=lambda v: int(_VERSION_RE.match(v).group(1)))
    return versions[-1] if versions else None


def save_versioned(model: DIALModel, root: str = "models/lab",
                   meta: dict | None = None) -> str:
    """Persist a campaign's model as the next ``models/lab/vNNN/``:
    ``dial.read.npz`` / ``dial.write.npz`` (:meth:`DIALModel.save`'s
    prefix layout), ``manifest.json`` and an updated ``LATEST``."""
    os.makedirs(root, exist_ok=True)
    prev = latest_version(root)
    nxt = "v%03d" % ((int(_VERSION_RE.match(prev).group(1)) + 1)
                     if prev else 1)
    d = os.path.join(root, nxt)
    os.makedirs(d)
    model.save(os.path.join(d, "dial"))
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"version": nxt, **(meta or {})}, f, indent=2,
                  default=str)
    with open(os.path.join(root, "LATEST"), "w") as f:
        f.write(nxt + "\n")
    return d


def load_versioned(root: str = "models/lab", version: str | None = None,
                   strict: bool = True, device=None) -> DIALModel:
    """Load one versioned artifact onto ``device`` (``None``: the CUDA
    card), refusing tampered or mismatched ones.

    When both the campaign ``manifest.json`` and the model's own
    ``dial.meta.json`` carry training provenance, they must agree: a
    mismatch means the forests on disk are not the ones this campaign
    trained, which ``strict`` turns into an error.
    """
    v = version or latest_version(root)
    if v is None:
        raise FileNotFoundError(f"no campaign artifacts under {root!r}")
    d = os.path.join(root, v)
    model = DIALModel.load(os.path.join(d, "dial"), device=device)
    if strict:
        manifest_meta = None
        manifest_ok = True
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest_meta = json.load(f).get("train_meta")
        except (OSError, ValueError):
            manifest_ok = False
        if not manifest_ok and model.train_meta:
            raise ValueError(
                f"artifact {d!r} is inconsistent: the model carries "
                "train_meta but manifest.json is missing or unreadable "
                "(pass strict=False to override)")
        if manifest_meta is not None and manifest_meta != model.train_meta:
            if not model.train_meta:
                raise ValueError(
                    f"artifact {d!r} is inconsistent: manifest carries "
                    "train_meta but the model's dial.meta.json is missing "
                    "or unreadable (forests on disk do not match the "
                    "campaign that wrote the manifest; pass strict=False "
                    "to override)")
            raise ValueError(
                f"artifact {d!r} is inconsistent: manifest train_meta "
                f"{manifest_meta} != model meta {model.train_meta} "
                "(forests on disk do not match the campaign that wrote "
                "the manifest; pass strict=False to override)")
    return model


def run_campaign(cfg: CampaignConfig = CampaignConfig(),
                 out_root: str = "models/lab",
                 gbdt_params: GBDTParams | None = None,
                 smoke: bool = False, device=None):
    """collect -> train -> save one versioned artifact, on ``device``
    (``None``: the CUDA card).

    ``smoke`` marks the manifest so quality-sensitive consumers
    (:func:`repro_torch.lab.evaluate.default_model`) refuse to inherit a
    CI-sized model silently.  Training is the port's exact trainer
    (:func:`repro_torch.core.dataset.train_models`); its provenance,
    with the dataset fingerprint, goes into both the manifest and the
    model's own metadata.  Returns ``(artifact_dir, model, info)``.
    """
    data = collect_batch(cfg, device=device)
    info = {
        "smoke": bool(smoke),
        "config": dataclasses.asdict(cfg),
        "samples": {op: int(len(data[op][0])) for op in ("read", "write")},
        "positive_rate": {op: (float(data[op][1].mean())
                               if len(data[op][1]) else 0.0)
                          for op in ("read", "write")},
    }
    model = train_models(data, gbdt_params, device=device)
    info["train_meta"] = model.train_meta
    d = save_versioned(model, out_root, meta=info)
    return d, model, info
