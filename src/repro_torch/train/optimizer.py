"""AdamW with a warmup + cosine schedule and global-norm clipping.

Mirrors ``repro/train/optimizer.py``: the step counter and the
schedule in float32, float32 moments, each parameter updated in float32
and cast back to its own dtype (bf16 rounds to nearest even, as
``astype`` does).  The port updates the parameters and moments in
place, leaf by leaf, so a step holds no second copy of either.

Decoupled weight decay goes on the leaves the reference decays.  The
reference decays a leaf of rank >= 2 in *its* layout, where every
repeated layer is stacked with a leading ``n_rep`` axis: so each norm
scale, bias and gate vector inside the stack is decayed, while those of
the tail layers and ``final_norm`` are not (recurrentgemma's two tail
layers show the difference).  :func:`decay_mask` reproduces that rule
on the port's flat layer list (ROADMAP Queue 3, reference fault 5:
kept, not fixed).

On a mesh the parameters are DTensors and the moments DTensors placed
by :func:`repro_torch.distributed.sharding.zero1_pspecs` (ZeRO-1:
sharded over the data axes too).  Each gradient is first laid out as
its moment -- a reduce-scatter of the data-partial gradient -- so the
norm, the moments and the update run on each rank's shard, and the
updated parameter is all-gathered back to its own layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.constrain import is_dtensor, laid_out_as


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> list:
    """The tensors of a parameter-shaped tree (dicts by sorted key, lists
    in order); two trees of one structure list their leaves alike."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in ``tree``'s
    structure: the inverse of :func:`tree_leaves`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)
    return build(tree)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def decay_mask(model_cfg, params) -> list:
    """Per leaf (:func:`tree_leaves` order), whether the reference decays
    it: rank >= 2 in the reference's layout, where a leaf of a stacked
    layer (index ``< n_rep * len(layer_pattern)``) has rank ``ndim + 1``."""
    n_stack = model_cfg.n_rep * len(model_cfg.layer_pattern)
    lift = {k: [0] * len(tree_leaves(v)) for k, v in params.items()
            if k != "layers"}
    lift["layers"] = [[int(j < n_stack)] * len(tree_leaves(layer))
                      for j, layer in enumerate(params["layers"])]
    return [p.dim() + r >= 2 for p, r in zip(tree_leaves(params),
                                             tree_leaves(lift))]


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine to ``min_lr``; float32."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, specs=None) -> dict:
    """``step`` (0-dim int32) and zero float32 moments ``m`` and ``v``
    shaped like ``params``, on its device.

    DTensor parameters get DTensor moments on their mesh, placed by the
    spec tree ``specs`` (``zero1_pspecs``, validated) or, without one,
    as each parameter; every rank allocates its own shard only."""
    if specs is None:
        def zeros(p):
            if is_dtensor(p):
                return _dt_zeros(p, p.placements)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        m, v = tree_map(zeros, params), tree_map(zeros, params)
    else:
        from repro_torch.distributed.sharding import map_specs, placements

        def zeros(spec, p):
            return _dt_zeros(p, placements(p.device_mesh, spec))
        m, v = map_specs(zeros, specs, params), map_specs(zeros, specs, params)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": m, "v": v}


def _dt_zeros(p, placements):
    from torch.distributed.tensor import zeros

    return zeros(p.shape, dtype=torch.float32, device_mesh=p.device_mesh,
                 placements=placements)


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


@torch.no_grad()
def adamw_update(params, grads: list, opt_state: dict, cfg: AdamWConfig,
                 decay: list):
    """One AdamW step, in place.  ``grads`` and ``decay`` are per leaf in
    :func:`tree_leaves` order (``decay`` from :func:`decay_mask`).
    Returns (params, opt_state, metrics), the same objects updated."""
    step = opt_state["step"] + 1
    moments = list(zip(tree_leaves(opt_state["m"]),
                       tree_leaves(opt_state["v"])))
    grads = [laid_out_as(g, m) for g, (m, _) in zip(grads, moments)]
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, (m, v), dec in zip(tree_leaves(params), grads, moments,
                                 decay):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)          # b1 m + (1 - b1) g
        gg = (1 - b2) * g
        v.mul_(b2).add_(gg.mul_(g))            # b2 v + ((1 - b2) g) g
        del g, gg
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = laid_out_as(p.float(), m)
        if dec:     # decoupled weight decay (the reference's leaf rule)
            delta = delta + cfg.weight_decay * pf
        # rounds to p's dtype, then back to p's layout
        p.copy_(laid_out_as((pf - lr * delta).to(p.dtype), p))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
