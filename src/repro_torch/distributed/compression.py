"""Gradient compression: int8 quantization with error feedback.

Mirrors ``repro/distributed/compression.py``.  For the cross-pod
gradient reduction (the slow hop on multi-pod meshes) gradients quantize
to int8 with a per-tensor absmax scale before the reduction; the
quantization residual accumulates in a local error-feedback buffer added
to the next step's gradient (Seide et al. 1-bit SGD / EF-SGD semantics).

``compressed_psum`` runs on every rank of the data axis's process group.
The arithmetic is exact int8 semantics in float32, as the reference's;
the reduction itself is carried in int32 (``all_reduce`` of the int8
payload widened, the reference's XLA carrier), so the *wire-byte* saving
(4x) is analytic: :func:`wire_bytes`.  A time measured here is the int32
reduction's, not an int8 one's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.constrain import is_dtensor
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def ef_compress(grad, error_buf):
    """Error-feedback compression of one tensor.

    Returns (int8 payload, scale, new_error_buf)."""
    g = grad.to(torch.float32) + error_buf
    q, scale = quantize_int8(g)
    new_err = g - dequantize(q, scale)
    return q, scale, new_err


def compressed_psum(grads, error_bufs, group=None):
    """EF-int8 compress + sum over the ranks of ``group`` (the data
    axis's, ``mesh.get_group("data")``), per leaf of a tree.

    Returns (reduced float32 grads, new error bufs): the int32 sum of
    the payloads times the mean scale, over the group size -- per-rank
    scales differ, and the mean is the reference's (the standard EF-SGD
    approximation; the residual lands in the error buffer)."""
    n = dist.get_world_size(group)

    def one(g, e):
        q, scale, new_e = ef_compress(g, e)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        scale_sum = scale.reshape(1).clone()
        dist.all_reduce(scale_sum, group=group)
        return total.to(torch.float32) * (scale_sum[0] / n) / n, new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(error_bufs))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def wire_bytes(grads, compressed: bool) -> float:
    """Analytic per-reduction wire bytes (ring all-reduce, 2x payload)."""
    n = sum(g.numel() for g in tree_leaves(grads))
    return 2.0 * n * (1 if compressed else 4)


def make_dp_train_grads(loss_fn, mesh, axis_name: str = "data",
                        compress: bool = True):
    """Pure-DP gradient computation with an EF-int8 cross-shard reduction.

    Returns ``grads_fn(params, batch, error_bufs) -> (loss, grads,
    bufs)``.  ``params`` are plain tensors, the same on every rank; the
    batch (a tensor, or a tuple / dict of them, global) splits over
    ``axis_name`` on its leading axis, and each rank backprops its own
    shard with ``loss_fn(params, shard)``.  The gradients then sum over
    the axis compressed (:func:`compressed_psum`) or are averaged
    exactly (``all_reduce`` over the group size in the gradient's
    dtype, the reference's ``pmean``); the loss is averaged.
    ``error_bufs`` is :func:`init_error_bufs`'s tree, its leading axis
    the coordinate on ``axis_name`` (sharded over it when made with the
    mesh): a rank reads its own row and writes the new one in place,
    and returns the tree.
    """
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    me = mesh.get_local_rank(axis_name)

    def shard(x):
        if isinstance(x, dict):
            return {k: shard(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(shard(v) for v in x)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} does not split over "
                             f"{n} ranks")
        b = x.shape[0] // n
        return x[me * b:(me + 1) * b]

    def pmean(t):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t / n

    def grads_fn(params, batch, error_bufs):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = loss_fn(params, shard(batch))
                g = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        grads = tree_unflatten(params, g)
        if compress:
            rows = tree_map(lambda b: b.to_local()[0] if is_dtensor(b)
                            else b[me], error_bufs)
            grads, mine = compressed_psum(grads, rows, group)
            for b, e in zip(tree_leaves(rows), tree_leaves(mine)):
                b.copy_(e)
        else:
            grads = tree_map(pmean, grads)
        return pmean(loss.detach()), grads, error_bufs

    return grads_fn


def init_error_bufs(params, n_shards: int, mesh=None,
                    axis_name: str = "data"):
    """Per-shard error-feedback buffers, leading axis = n_shards.

    With ``mesh``, each is a DTensor whose leading axis is sharded over
    ``axis_name`` (of size ``n_shards``), as the reference's buffer is
    sharded over the data axis: a rank allocates its own row only."""
    if mesh is None:
        return tree_map(lambda p: torch.zeros(
            (n_shards,) + tuple(p.shape), dtype=torch.float32,
            device=p.device), params)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if mesh.size(mesh.mesh_dim_names.index(axis_name)) != n_shards:
        raise ValueError(f"{n_shards} error buffers for the {axis_name} "
                         f"axis of {mesh}")
    where = [Shard(0) if n == axis_name else Replicate()
             for n in mesh.mesh_dim_names]
    return tree_map(lambda p: DTensor.from_local(torch.zeros(
        (1,) + tuple(p.shape), dtype=torch.float32, device=p.device),
        mesh, where, run_check=False), params)
