"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell
on the production mesh, in one CPU process, with no allocation.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape decode_32k --both-meshes --out build/dryrun

The counterpart of ``repro/launch/dryrun.py``.  The reference lowers
and compiles each step for 256 / 512 forced host devices; here the
process joins a fake process group of 256 (or 512) ranks as rank 0
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once, nothing moves), builds the production mesh over it
(:func:`repro_torch.launch.mesh.make_production_mesh`), and runs one
step eagerly under ``FakeTensorMode`` (tensors carry shapes, dtypes and
devices, no storage): parameters from ``init_params``, placed by
``param_pspecs`` -> ``validate_pspecs`` -> ``distribute``; the train
step with ZeRO-1 moments and the reference's ``baseline_grad_accum``;
decode over a cache from ``init_cache(mesh=..., shard_seq=global_batch
== 1)``.  The step runs under :class:`CollectiveRecorder` (every
collective this rank issues, with its bytes) and ``FlopCounterMode``.

A record keeps the reference's keys where they mean the same thing:
``arch``, ``shape``, ``mesh``, ``chips``, ``kind``, ``grad_accum`` /
``shard_seq``, ``flops_per_chip`` and ``hbm_bytes_per_chip`` (the
analytic :func:`repro_torch.utils.flops.cell_cost`),
``collective_counts``, ``collective_bytes_by_kind``,
``wire_bytes_per_chip`` and ``roofline`` (at the H100's peaks,
:mod:`repro_torch.utils.roofline`).  It adds ``torch_flops_raw``,
``argument_bytes_per_chip`` (the local shards of parameters, optimizer
state, inputs and cache on this rank) and ``trace_s`` (the eager step's
wall time, in place of ``compile_s``).  ``--jobs N`` traces N cells at
a time, each in a worker process of its own fake group.
``torch_flops_raw`` is
``FlopCounterMode``'s count, and two things make it no per-chip figure:
on DTensors it counts each operator's global shape, not the rank's
shard (``torch_flops_scope``), and under the fake mode the CPU dispatch
runs the kernels' plain versions (materialized attention), so it
counts those forms' matmuls -- but not the sequential scans': the
selective scan and the RG-LRU are custom operators whose fake functions
give shapes only, and the Mamba training form's step loop is swapped,
while a cell is traced, for :func:`_scan_stand_in` (its 4,096 to
32,768 steps of elementwise ops would take hours to dispatch, and issue
no collective).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, applicable_shapes

TAGS = {False: "pod", True: "multipod"}


def ensure_world(size: int) -> None:
    """This process as rank 0 of a fake process group of ``size`` ranks
    (the existing group destroyed when its size differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _dp_size(mesh) -> int:
    from repro_torch.distributed import sharding as shd

    n = 1
    for a in shd.dp_axes(mesh):
        n *= shd.axis_sizes(mesh)[a]
    return n


def input_specs(cfg, shape, mesh) -> dict:
    """The step's inputs (fake tensors under the caller's mode) placed as
    the reference's ``input_specs``: batch over the data axes, or
    replicated when it does not divide them (batch-1 decode)."""
    import torch

    from repro_torch.distributed import sharding as shd

    b, s = shape.global_batch, shape.seq_len
    rows = shd.batch_pspec(mesh) if b % _dp_size(mesh) == 0 else (None,)
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    out = {}
    if shape.kind in ("train", "prefill"):
        s_text = s - (cfg.img_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = torch.zeros((b, s_text) + cb, dtype=torch.int64)
        if shape.kind == "train":
            out["labels"] = torch.zeros((b, s_text) + cb, dtype=torch.int64)
        if cfg.family == "vlm":
            out["img_embeds"] = torch.zeros((b, cfg.img_tokens, cfg.d_model),
                                            dtype=torch.bfloat16)
    else:
        out["tokens"] = torch.zeros((b, 1) + cb, dtype=torch.int64)
    return shd.distribute(out, mesh, {k: shd.P(*rows, *(None,) * (
        v.dim() - 1)) for k, v in out.items()})


def baseline_grad_accum(shape, mesh) -> int:
    """Microbatches of 2 sequences per data rank (the reference's)."""
    return max(shape.global_batch // _dp_size(mesh) // 2, 1)


def _local_bytes(tree) -> int:
    from repro_torch.distributed.constrain import is_dtensor
    from repro_torch.train.optimizer import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        loc = t.to_local() if is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def _scan_stand_in(uf, df, A, bf, cf, D):
    """The shape of ``models/mamba.py::_scan``'s output, in one line
    that reaches every input, so autograd's graph (and the gradients'
    collectives) does too."""
    return (uf * df * (bf.sum(-1, keepdim=True) + cf.sum(-1, keepdim=True))
            + A.sum(-1) * D * uf)


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               grad_accum: int | None = None, *, cfg=None,
               shape=None) -> dict:
    """One step of the cell, fake and recorded; the record without the
    analytic terms.  ``cfg`` / ``shape`` replace the arch's published
    config and the named shape (a test's cut cell)."""
    from unittest import mock

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import lm, mamba
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)
    from repro_torch.utils.roofline import CollectiveRecorder

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ensure_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = {"arch": arch, "shape": shape_name, "mesh": list(mesh.shape),
           "chips": mesh.size(), "kind": shape.kind}
    with FakeTensorMode(allow_non_fake_inputs=True), \
            mock.patch.object(mamba, "_scan", _scan_stand_in):
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
        specs = shd.validate_pspecs(shd.param_pspecs(params), params, mesh)
        params = shd.distribute(params, mesh, specs)
        inputs = input_specs(cfg, shape, mesh)
        args_bytes = _local_bytes(params) + _local_bytes(inputs)
        if shape.kind == "train":
            accum = grad_accum or baseline_grad_accum(shape, mesh)
            zspecs = shd.validate_pspecs(shd.zero1_pspecs(params, specs,
                                                          mesh), params, mesh)
            state = init_opt_state(params, zspecs)
            args_bytes += _local_bytes(state)
            step = make_train_step(cfg, AdamWConfig(), grad_accum=accum)
            run = lambda: step(params, state, inputs)  # noqa: E731
            rec["grad_accum"] = accum
        elif shape.kind == "prefill":
            step = make_prefill_step(cfg, max_len=shape.seq_len)
            run = lambda: step(params, inputs["tokens"],  # noqa: E731
                               inputs.get("img_embeds"))
        else:
            shard_seq = shape.global_batch == 1
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  None, mesh=mesh, shard_seq=shard_seq)
            args_bytes += _local_bytes(cache)
            step = make_decode_step(cfg)
            run = lambda: step(params, inputs["tokens"], cache,  # noqa: E731
                               shape.seq_len - 1)
            rec["shard_seq"] = shard_seq
        recorder = CollectiveRecorder()
        flops = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with flops, recorder:
            run()
        rec["trace_s"] = time.perf_counter() - t0
    stats = recorder.stats
    rec["torch_flops_raw"] = float(flops.get_total_flops())
    rec["torch_flops_scope"] = ("FlopCounterMode: each operator at its "
                                "global (DTensor) shape, plain CPU forms")
    rec["argument_bytes_per_chip"] = args_bytes
    rec["collective_counts"] = dict(stats.counts)
    rec["collective_bytes_by_kind"] = {k: int(v) for k, v in
                                       stats.bytes_by_kind.items()}
    rec["wire_bytes_per_chip"] = float(stats.total_wire_bytes)
    return rec


def analyze(rec: dict, *, cfg=None, shape=None,
            window_cache: bool = False) -> dict:
    """Add the analytic cost and the roofline terms to a traced record
    (``window_cache``: the analytic cache term of a decode that reads
    only a window layer's live window, as the port's does)."""
    from repro_torch.utils import flops as flops_util
    from repro_torch.utils.roofline import Roofline, link_bw

    cfg = cfg or get_config(rec["arch"])
    shape = shape or SHAPES[rec["shape"]]
    model_shards = rec["mesh"][-1]
    cost = flops_util.cell_cost(
        cfg, shape, chips=rec["chips"], model_shards=model_shards,
        grad_accum=rec.get("grad_accum", 1), remat=True,
        window_cache=window_cache)
    if window_cache:
        rec["window_cache"] = True
    rec["flops_per_chip"] = cost.flops_per_chip
    rec["hbm_bytes_per_chip"] = cost.hbm_bytes_per_chip
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    roof = Roofline(flops=cost.flops_per_chip,
                    hbm_bytes=cost.hbm_bytes_per_chip,
                    wire_bytes=rec["wire_bytes_per_chip"],
                    model_flops=model_flops, chips=rec["chips"],
                    link_bw=link_bw(max(rec["mesh"])))
    rec["roofline"] = roof.to_dict()
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             grad_accum: int | None = None, *, cfg=None, shape=None) -> dict:
    """Trace and analyze one cell; write its record to ``out_dir``."""
    rec = analyze(trace_cell(arch, shape_name, multi_pod,
                             grad_accum=grad_accum, cfg=cfg, shape=shape),
                  cfg=cfg, shape=shape)
    os.makedirs(out_dir, exist_ok=True)
    tag = TAGS[multi_pod]
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[dryrun] {arch} x {shape_name} x {tag}: "
          f"dominant={r['dominant']} compute={r['compute_s']:.4f}s "
          f"memory={r['memory_s']:.4f}s "
          f"collective={r['collective_s']:.4f}s "
          f"(trace {rec['trace_s']:.1f}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at a time, one process each")
    args = ap.parse_args(argv)

    cells = []
    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    for mp in meshes:                    # one process group per mesh size
        for a in archs:
            shapes = applicable_shapes(a) if (args.all or args.shape is None) \
                else [args.shape]
            cells += [(a, s, mp) for s in shapes]

    t0 = time.perf_counter()
    failures = []

    def failed(cell, e):
        failures.append(cell + (repr(e),))
        print(f"[dryrun] FAILED {cell[0]} x {cell[1]} x {TAGS[cell[2]]}: "
              f"{e!r}", flush=True)

    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing

        from repro_torch.launch import dryrun as this

        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            futs = {pool.submit(this.run_cell, a, s, mp, args.out,
                                args.grad_accum): (a, s, mp)
                    for a, s, mp in cells}
            for fut in cf.as_completed(futs):
                if fut.exception() is not None:
                    failed(futs[fut], fut.exception())
    else:
        for a, s, mp in cells:
            try:
                run_cell(a, s, mp, args.out, grad_accum=args.grad_accum)
            except Exception as e:
                failed((a, s, mp), e)
    print(f"[dryrun] {len(cells) - len(failures)} of {len(cells)} cells "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
