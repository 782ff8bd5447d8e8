"""Sharding rules of the LM (parameters, ZeRO-1 optimizer moments,
batches, decode caches) and the DIAL fleet axis.

Mirrors ``repro/distributed/sharding.py``.

**The LM's mesh** is a :class:`torch.distributed.device_mesh.DeviceMesh`
with named dims ``("data", "model")``, or ``("pod", "data", "model")``
across pods (:func:`repro_torch.launch.mesh.make_test_mesh`).  Batch and
gradient reduction use (pod, data); tensor parallelism (heads / ffn /
experts / vocab) uses ``model``.  A spec is a :class:`PartitionSpec`: a
tuple with one entry per tensor dim, each ``None`` (replicated), a mesh
axis name, or a tuple of names (the dim split over them, major first).
:func:`named` turns a spec tree into DTensor placements on a mesh and
:func:`distribute` places a tree of tensors by one.  The functions that
read a mesh take a ``DeviceMesh`` or a ``{axis name: size}`` dict.

Rules are keyed by parameter *name* (the innermost dict key), as the
reference keys them.  The reference stacks its repeated layers with a
leading ``n_rep`` axis; the port keeps one dict per layer, so the
reference's spec of a stacked leaf is the port's spec with a leading
``None``.  Two places differ (ROADMAP Queue 3):

- the reference's shared-expert leaves (``moe/shared/{gate,up,down}``,
  Qwen2-MoE) match its ``moe`` branch before its ``shared`` branch, so
  it shards their stacked ``n_rep`` axis over ``model``; a per-layer
  leaf has no such axis, and the port applies the dense MLP rule that
  the reference's ``shared`` branch states;
- ZeRO-1 shards the largest replicated dim that divides the data size;
  where that dim is the reference's ``n_rep`` axis, the port's leaf
  (which lacks it) takes the next such dim of its own, or keeps its
  parameter spec.  That changes memory, never values.

**The fleet axis** (:data:`FLEET_AXIS`) is the simulator-side
counterpart.  A batch of B scenarios is one block-diagonal fleet
(:mod:`repro_torch.lab.batch`), and every DIAL decision reads only its
own interface's counters, so the batch splits over devices along its
elements with no communication: each device runs a contiguous shard of
elements as a fleet of its own.  A fleet mesh is a tuple of
``torch.device``; :func:`fleet_mesh` builds one, and :func:`pad_fleet`
/ :func:`unpad_fleet` pad a batch that does not divide the device count
and drop the phantoms again.
"""

from __future__ import annotations

import numpy as np
import torch

#: the name of the one axis a fleet mesh has (the reference's
#: ``PartitionSpec`` axis name; kept for the records that name it)
FLEET_AXIS = "fleet"


def fleet_mesh(n_devices: int | None = None, *, devices=None) -> tuple:
    """A 1-D fleet mesh: a tuple of ``torch.device``.

    Every visible CUDA device by default, the first ``n_devices``
    otherwise; ``devices=`` takes explicit ones (any device, repeats
    allowed: the CPU tests split a batch over several ``"cpu"``
    entries).  Raises when more devices are asked for than exist.
    """
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if n_devices is not None:
            mesh = mesh[:n_devices]
        if not mesh:
            raise ValueError("fleet mesh over no devices")
        return mesh
    n_visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_visible == 0:
        raise RuntimeError("fleet_mesh: no CUDA device is visible (pass "
                           "devices=[...] to name devices explicitly)")
    if n_devices is not None and n_devices > n_visible:
        raise ValueError(f"fleet mesh wants {n_devices} devices but only "
                         f"{n_visible} are visible")
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"fleet mesh wants {n_devices} devices")
    return tuple(torch.device("cuda", i)
                 for i in range(n_visible if n_devices is None
                                else n_devices))


def fleet_batch_size(tree) -> int:
    """Leading-axis extent shared by every leaf of a stacked batch (a
    tensor, an array, or a list / tuple / dict of them)."""
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("empty tree has no batch axis")
    return int(leaves[0].shape[0])


def pad_fleet(tree, n_shards: int, n_pad: int | None = None):
    """Pad every leaf's leading batch axis up to a multiple of
    ``n_shards`` by repeating element 0.

    Returns ``(padded_tree, n_pad)``.  Callers that carry per-element
    *decision* masks pad those with ``False`` themselves, so phantom
    elements never decide.
    """
    b = fleet_batch_size(tree)
    if n_pad is None:
        n_pad = (-b) % int(n_shards)
    if n_pad == 0:
        return tree, 0

    def one(a):
        if torch.is_tensor(a):
            return torch.cat([a, a[:1].repeat((n_pad,) + (1,) * (a.dim()
                                                                - 1))])
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[:1], n_pad, axis=0)])
    return _map(one, tree), n_pad


def unpad_fleet(tree, n_pad: int):
    """Strip :func:`pad_fleet`'s phantom trailing elements again."""
    if n_pad == 0:
        return tree
    return _map(lambda a: a[:-n_pad], tree)


def shard_elements(n_elems: int, n_shards: int) -> list:
    """The element indices each shard runs: contiguous and equal, the
    batch padded by repeating element 0 (:func:`pad_fleet`'s rule)."""
    idx, _ = pad_fleet(np.arange(n_elems), n_shards)
    return list(idx.reshape(int(n_shards), -1))


# --------------------------------------------------------------------- #
# the LM: specs over a ("data", "model") or ("pod", "data", "model") mesh
# --------------------------------------------------------------------- #
class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name, or a tuple of
    names; ``PartitionSpec("data", None)``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """Data-parallel mesh axes (includes 'pod' when present)."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_pspec(mesh) -> PartitionSpec:
    return P(dp_axes(mesh))


# per-name rules, one entry per dim of a per-layer leaf
_RULES = {
    # attention
    "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "wo": ("model", None),
    # mlp
    "gate": (None, "model"), "up": (None, "model"), "down": ("model", None),
    # moe (leading expert axis -> expert parallel over 'model')
    "router": (None, None),
    "moe_gate": ("model", None, None), "moe_up": ("model", None, None),
    "moe_down": ("model", None, None),
    "shared_gate": (None,),
    # mamba
    "in_proj": (None, "model"), "conv_w": ("model", None),
    "x_proj": ("model", None), "dt_proj": (None, "model"),
    "dt_bias": ("model",), "A_log": ("model", None), "D": ("model",),
    "out_proj": ("model", None),
    # rglru
    "in_gate": (None, "model"), "in_lin": (None, "model"),
    "wa": (None, "model"), "wx": (None, "model"),
    "ba": ("model",), "bx": ("model",), "lam": ("model",),
    # norms
    "scale": (None,), "bias": (None,),
}


def _with_paths(fn, tree, names=()):
    """``fn(names, leaf)`` over a parameter-shaped tree, ``names`` the
    dict keys on the way to the leaf (list indices skipped, as the
    reference keeps only ``DictKey``s)."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_paths(fn, v, names) for v in tree]
    return fn(names, tree)


def _spec_for(names, leaf) -> tuple:
    name, parents = names[-1], names[:-1]
    ndim = leaf.dim()
    if name == "embed":                   # vocab-sharded
        spec = ("model", None, None)[-ndim:] if ndim == 3 \
            else ("model", None)
    elif name == "head":
        spec = (None, None, "model")[-ndim:] if ndim == 3 \
            else (None, "model")
    elif "shared" in parents:             # qwen2moe shared expert = dense mlp
        spec = _RULES[name]
    elif "moe" in parents and name in ("gate", "up", "down"):
        spec = _RULES["moe_" + name]
    else:
        spec = _RULES.get(name, (None,) * ndim)
    if len(spec) != ndim:
        raise ValueError(f"no sharding rule for {'/'.join(names)} of shape "
                         f"{tuple(leaf.shape)} (rule {spec})")
    return tuple(spec)


def param_pspecs(params):
    """The :class:`PartitionSpec` tree of a parameter tree (tensors on any
    device, ``meta`` included)."""
    return _with_paths(lambda n, leaf: P(*_spec_for(n, leaf)), params)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (dict keys
    sorted, lists in order)."""
    if _is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and a tree of its structure."""
    if _is_spec(specs):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, tree[k]) for k, v in specs.items()}
    return [map_specs(fn, s, t) for s, t in zip(specs, tree)]


def _axis_size(sizes: dict, a) -> int:
    if a is None:
        return 1
    n = 1
    for x in (a if isinstance(a, tuple) else (a,)):
        n *= sizes[x]
    return n


def validate_pspecs(pspecs, tree, mesh):
    """Drop mesh axes from dims they don't divide (e.g. qwen2-moe's 60
    experts on a 16-way ``model`` axis fall back to replication)."""
    sizes = axis_sizes(mesh)

    def one(spec, leaf):
        spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
        return P(*(a if a is not None and d % _axis_size(sizes, a) == 0
                   else None for d, a in zip(leaf.shape, spec)))
    return map_specs(one, pspecs, tree)


def zero1_pspecs(params, pspecs, mesh):
    """Optimizer-moment specs: param spec + data-axis sharding (ZeRO-1).

    For each leaf, shard the largest dim that is currently replicated and
    divisible by the data-parallel world size (the first of equal ones).
    Falls back to the param spec when nothing divides.  ``pspecs`` is
    unused, as in the reference, which derives the rule anew."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(sizes)
    dp_size = _axis_size(sizes, dp) if dp else 1

    def one(names, leaf):
        spec = list(_spec_for(names, leaf))
        if dp_size > 1:
            order = sorted(range(leaf.dim()), key=lambda i: -leaf.shape[i])
            for i in order:
                if spec[i] is None and leaf.shape[i] % dp_size == 0:
                    spec[i] = dp if len(dp) > 1 else dp[0]
                    break
        return P(*spec)
    return _with_paths(one, params)


def cache_pspecs(cfg, cache, mesh, shard_seq: bool = False):
    """Decode-cache specs of the port's per-layer cache list.

    Default: batch over data axes, kv-heads (or head_dim) over 'model'.
    ``shard_seq=True`` (long-context, batch=1): the KV sequence axis
    shards over the data axes instead.  Attention ``k``/``v`` are the
    port's ``(B, Hkv, S, Dh)``: the reference's ``(B, S, Hkv, Dh)`` spec
    with its dims 1 and 2 swapped, as ``convert.py`` swaps the arrays.
    """
    sizes = axis_sizes(mesh)
    dp = dp_axes(sizes)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    kv_heads_ok = cfg.n_kv_heads % sizes["model"] == 0

    def one(names, leaf):
        name = names[-1]
        if name in ("k", "v"):              # (B, Hkv, S, Dh)
            head, dh = ("model", None) if kv_heads_ok else (None, "model")
            spec = (None, head, dp_spec, dh) if shard_seq \
                else (dp_spec, head, None, dh)
        elif name == "conv":                # (B, K-1, W)
            spec = (None, None, "model") if shard_seq \
                else (dp_spec, None, "model")
        elif name == "ssm":                 # (B, Di, N)
            spec = (None, "model", None) if shard_seq \
                else (dp_spec, "model", None)
        elif name == "h":                   # (B, W)
            spec = (None, "model") if shard_seq else (dp_spec, "model")
        else:
            spec = ()
        return P(*((None,) * (leaf.dim() - len(spec)) + spec))
    return _with_paths(one, cache)


def placements(mesh, spec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, a in enumerate(spec):
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


def named(mesh, spec_tree):
    """A spec tree as a tree of placement lists on ``mesh``."""
    return map_specs(lambda s, _: placements(mesh, s), spec_tree, spec_tree)


def distribute(tree, mesh, spec_tree):
    """``tree``'s tensors as DTensors on ``mesh``, placed by ``spec_tree``.

    Every rank holds the same full tensors (built from one seed, or read
    from one checkpoint) and keeps a copy of its own shard of each: no
    data moves, and the full tensors can be freed after.
    """
    from torch.distributed.tensor import DTensor, distribute_tensor

    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def one(spec, t):
        dt = distribute_tensor(t.detach().to(dev), mesh,
                               placements(mesh, spec), src_data_rank=None)
        loc = dt.to_local()
        if loc.untyped_storage().nbytes() == loc.numel() * loc.element_size():
            return dt
        # a shard cut on dim 0 is a view of the whole tensor
        return DTensor.from_local(loc.clone(), mesh, dt.placements,
                                  run_check=False, shape=dt.shape,
                                  stride=dt.stride())
    return map_specs(one, spec_tree, tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
