"""Checkpoint manager: durable save/restore + PFS write-path accounting.

Mirrors ``repro/ckpt/manager.py``.  Two concerns, kept apart:

1. **Durability** -- parameters, optimizer state and the pipeline cursor
   serialize to local ``.npz`` files with the reference's keys and
   layouts (``params/stack/<i>/...`` with the leading ``n_rep`` axis,
   ``params/tail/<j>/...``, ``opt/m/...``; bfloat16 stored as float32
   and cast back on restore), so a checkpoint written by either package
   restores in the other.  A file becomes visible only by atomic rename;
   ``keep`` bounds disk use.

2. **PFS accounting** -- :meth:`CheckpointManager.pfs_write` pushes the
   byte volume through each host's simulated client write path (grants,
   dirty cache, RPC formation), where the DIAL agent tunes it, and
   returns how long the PFS took to absorb it (sim seconds).

``restore_latest()`` and the pipeline cursor give exact-step resume.

Under a mesh (DTensor parameters or moments) every rank gathers each
leaf whole (``full_tensor()``, one leaf at a time, to the host), rank 0
alone writes the file, and every rank waits for it at a barrier: the
format is mesh-agnostic, so :func:`reshard_checkpoint` places a restored
tree onto a mesh of another shape.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch.distributed as dist

from repro_torch.convert import (lm_params_from_numpy, lm_params_to_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.distributed.constrain import full, is_dtensor
from repro_torch.train.optimizer import tree_leaves, tree_map


def _flatten(tree, prefix="", out=None):
    """The reference's key paths: ``a/b/0/c``, dict keys sorted."""
    out = out if out is not None else {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict) -> dict:
    """Key paths back into nested dicts; a dict whose keys are all
    indices becomes a tuple (the reference's ``stack`` and ``tail``)."""
    root: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _like(tree, template):
    """``tree``'s leaves cast to the template's dtypes; shapes must
    match."""
    if isinstance(template, dict):
        if set(tree) != set(template):
            raise ValueError("checkpoint does not match the template's keys")
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(tree) != len(template):
            raise ValueError("checkpoint does not match the template's layers")
        return [_like(a, b) for a, b in zip(tree, template)]
    if tree.shape != template.shape:
        raise ValueError(f"checkpoint leaf {tuple(tree.shape)} does not "
                         f"match the template's {tuple(template.shape)}")
    return tree.to(template.dtype)


class CheckpointManager:
    """``cfg`` is the LM's config, which :meth:`save` and :meth:`restore`
    need to write and read the reference's stacked layout; a manager
    without one only accounts PFS writes."""

    def __init__(self, directory: str, keep: int = 3, sim=None,
                 hosts: list[int] | None = None, cfg=None):
        self.dir = directory
        self.keep = keep
        self.sim = sim
        self.hosts = hosts or ([0] if sim is not None else [])
        self.cfg = cfg
        os.makedirs(directory, exist_ok=True)

    def _model_cfg(self):
        if self.cfg is None:
            raise ValueError("CheckpointManager: save/restore need the "
                             "model's cfg")
        return self.cfg

    # ------------------------------------------------------------------ #
    def save(self, step: int, params, opt_state=None,
             extra: dict | None = None, through_pfs: bool = True) -> str:
        cfg = self._model_cfg()
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        sharded = any(is_dtensor(t) for t in tree_leaves(params))
        if sharded:
            params = tree_map(lambda t: full(t).cpu(), params)
            if opt_state is not None:
                opt_state = tree_map(lambda t: full(t).cpu(), opt_state)
            if dist.get_rank() != 0:
                dist.barrier()
                return path
        try:
            self._write(cfg, path, step, params, opt_state, extra,
                        through_pfs)
        finally:
            if sharded:
                dist.barrier()
        return path

    def _write(self, cfg, path, step, params, opt_state, extra,
               through_pfs) -> None:
        flat = _flatten({
            "params": lm_params_to_numpy(cfg, params),
            "opt": ({} if opt_state is None
                    else opt_state_to_numpy(cfg, opt_state))})
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        meta = {"step": step, "extra": extra or {}}
        with open(path + ".meta.tmp", "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)                       # atomic visibility
        os.replace(path + ".meta.tmp", path + ".meta")
        if through_pfs and self.sim is not None:
            nbytes = sum(v.nbytes for v in flat.values())
            self.pfs_write(nbytes)
        self._gc()

    def pfs_write(self, nbytes: float) -> float:
        """Push the checkpoint bytes through each host's client write path;
        returns sim-seconds until the dirty cache fully drains."""
        per_host = nbytes / max(len(self.hosts), 1)
        for h in self.hosts:
            osc = self.sim.osc_id(h, h % self.sim.n_osts)
            remaining = per_host
            guard = 0
            while remaining > 0 and guard < 100000:
                got = self.sim.submit_write(osc, min(remaining, 8 * 2**20),
                                            0.0, 8 * 2**20)
                remaining -= got
                if got <= 0:
                    self.sim.step()
                guard += 1
        t0 = self.sim.now
        guard = 0
        while float(self.sim.dirty_bytes.sum()) > 1.0 and guard < 200000:
            self.sim.step()
            guard += 1
        return self.sim.now - t0

    # ------------------------------------------------------------------ #
    def latest_step(self) -> int | None:
        steps = [int(f[5:13]) for f in os.listdir(self.dir)
                 if f.startswith("ckpt_") and f.endswith(".npz")
                 and not f.endswith(".tmp.npz")]
        return max(steps) if steps else None

    def restore(self, step: int, params_template, opt_template=None):
        """The checkpoint of ``step`` as the port's trees, on the
        templates' device and in their dtypes; returns (params, opt,
        meta)."""
        cfg = self._model_cfg()
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        with np.load(path) as z:
            tree = _unflatten({k: z[k] for k in z.files})
        # an empty tail (no layers past the stack) leaves no keys behind
        for t in (tree["params"], *(tree.get("opt", {}).get(k, {})
                                    for k in ("m", "v"))):
            t.setdefault("tail", ())
        dev = tree_leaves(params_template)[0].device
        params = _like(lm_params_from_numpy(cfg, tree["params"], dev),
                       params_template)
        opt = {}
        if opt_template is not None:
            opt = _like(opt_state_from_numpy(cfg, tree["opt"], dev),
                        opt_template)
        meta = {}
        if os.path.exists(path + ".meta"):
            with open(path + ".meta") as f:
                meta = json.load(f)
        return params, opt, meta

    def restore_latest(self, params_template, opt_template=None):
        step = self.latest_step()
        if step is None:
            return None
        params, opt, meta = self.restore(step, params_template, opt_template)
        return step, params, opt, meta

    def _gc(self) -> None:
        files = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("ckpt_") and f.endswith(".npz")
                       and not f.endswith(".tmp.npz"))
        for f in files[:-self.keep]:
            os.remove(os.path.join(self.dir, f))
            meta = os.path.join(self.dir, f.replace(".npz", ".npz.meta"))
            if os.path.exists(meta):
                os.remove(meta)


def reshard_checkpoint(params, new_mesh, pspecs):
    """Elastic re-mesh: place a restored tree (plain tensors, the same on
    every rank) onto ``new_mesh`` by the spec tree ``pspecs`` (validated
    for that mesh); each rank keeps its own shards."""
    from repro_torch.distributed.sharding import distribute

    return distribute(params, new_mesh, pspecs)
