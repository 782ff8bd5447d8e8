"""The rank program of ``test_torch_distributed.py``: four CPU processes
over ``gloo`` run the port's distributed pieces and rank 0 writes what
they gave.

    python tests/torch_mesh_ranks.py JOB.json

The job (JSON) names a ``file://`` rendezvous, the result path, and:

- ``cases``: sharded train steps on a 2 x 2 ``("data", "model")`` mesh,
  each from a parameter tree saved with ``torch.save`` and a stack of
  token batches (``.npy``): the gradients of the first batch at the
  saved parameters (``.grads.npz``), the metrics of every step and the
  parameters after the last, gathered (``.npz``, leaves in
  ``tree_leaves`` order);
- ``zero1``: one case whose gradients are laid out onto its ZeRO-1
  moments under ``CommDebugMode``: the gradients' placements and the
  collectives that layout issued;
- ``ef``: the reference test's 30-step EF-int8 loop over the data axis
  of a 4 x 1 mesh, compressed and plain, and the rows of the error
  buffer each rank holds;
- ``remesh``: a parameter tree saved under the 2 x 2 mesh, restored and
  re-placed on 4 x 1 and 1 x 4, every leaf compared with the source;
- ``serve``: sharded prefill and greedy decode steps of saved parameters
  and prompts on the mesh each case names, every step's logits gathered
  (``.npz``), and for a batch-1 case the collectives of one decode step
  (:class:`repro_torch.utils.roofline.CollectiveRecorder`) beside the
  bytes of each rank's attention cache shard;
- the mesh of the wrong size, which must raise, and a multi-pod one;
- ``raise_on``: that rank raises while the others wait for it in an
  all-reduce (a rank that raises must end the run).

Torch only: the test compares these with the reference.
"""

import dataclasses
import datetime
import json
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _opt(job):
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(**job["opt"])


def _batch(mesh, tok):
    from repro_torch.distributed import sharding as shd
    t = torch.as_tensor(tok).long()
    spec = shd.P(*shd.batch_pspec(mesh), *(None,) * (t.dim() - 1))
    return shd.distribute({"tokens": t, "labels": t}, mesh,
                          {"tokens": spec, "labels": spec})


def _placed(cfg, mesh, path):
    """The saved tree on ``mesh``: params by ``param_pspecs``, moments by
    ``zero1_pspecs``, both validated."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import init_opt_state
    params = torch.load(path, weights_only=True)
    specs = shd.validate_pspecs(shd.param_pspecs(params), params, mesh)
    params = shd.distribute(params, mesh, specs)
    zspecs = shd.validate_pspecs(shd.zero1_pspecs(params, specs, mesh),
                                 params, mesh)
    return params, init_opt_state(params, zspecs), specs


def grads_of(cfg, params, batch) -> list:
    """The loss's gradients at ``params`` (plain tensors or DTensors) on
    ``batch``, whole, float32, in ``tree_leaves`` order."""
    from repro_torch.distributed.constrain import full
    from repro_torch.models import lm
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import _on_mesh

    leaves = tree_leaves(params)
    with _on_mesh(leaves[0]), torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            g = torch.autograd.grad(lm.loss_fn(params, batch, cfg), leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    return [full(x).float() for x in g]


def run_case(case, mesh, job, rank):
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              param_dtype=case["dtype"])
    if case.get("mesh"):
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(*case["mesh"], device_type="cpu")
    params, state, _ = _placed(cfg, mesh, case["params"])
    grads = grads_of(cfg, params, _batch(mesh, np.load(case["batches"])[0]))
    if rank == 0:
        np.savez(case["out"].replace(".npz", ".grads.npz"),
                 *[g.numpy() for g in grads])
    step = make_train_step(cfg, _opt(job), grad_accum=case["grad_accum"])
    metrics = []
    for tok in np.load(case["batches"]):
        params, state, m = step(params, state, _batch(mesh, tok))
        metrics.append({k: float(v) for k, v in m.items()})
    leaves = [p.full_tensor().float().numpy() for p in tree_leaves(params)]
    if rank == 0:
        np.savez(case["out"], *leaves)
    return metrics


def run_zero1(case, mesh, job):
    """Gradients of one microbatch laid out as the moments, the way
    ``adamw_update`` lays them out; and, to count what the data axis
    alone costs, with only their data-axis placement changed to the
    moment's: the collectives that issues."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.constrain import laid_out_as
    from repro_torch.models import lm
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.steps import _on_mesh

    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              param_dtype=case["dtype"])
    params, state, _ = _placed(cfg, mesh, case["params"])
    leaves = tree_leaves(params)
    batch = _batch(mesh, np.load(case["batches"])[0])
    with _on_mesh(leaves[0]), torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(lm.loss_fn(params, batch, cfg), leaves)
        moments = tree_leaves(state["m"])
        data = mesh.mesh_dim_names.index("data")
        scatter = sum(isinstance(g.placements[data], Partial)
                      and isinstance(m.placements[data], Shard)
                      for g, m in zip(grads, moments))
        partial = sum(isinstance(g.placements[data], Partial) for g in grads)
        laid = [laid_out_as(g, m) for g, m in zip(grads, moments)]
        comm = CommDebugMode()
        with comm:
            for g, m in zip(grads, moments):
                want = list(g.placements)
                want[data] = m.placements[data]
                g.redistribute(mesh, want)
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    return dict(n_leaves=len(leaves), partial_on_data=partial,
                partial_to_shard=scatter, counts=counts,
                laid_as_moments=all(a.placements == m.placements
                                    for a, m in zip(laid, moments)))


def run_ef(job, rank):
    """The reference test's loop: W (16, 4), X (64, 16), Y (64, 4) from
    ``default_rng(0)``, lr 0.05, 30 steps, compressed and plain."""
    from repro_torch.distributed.compression import (init_error_bufs,
                                                     make_dp_train_grads)
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(WORLD, 1, device_type="cpu")
    rng = np.random.default_rng(0)
    w0 = torch.tensor(rng.normal(size=(16, 4)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(64, 16)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(64, 4)), dtype=torch.float32)

    def loss_fn(w, batch):
        xb, yb = batch
        return torch.mean((xb @ w - yb) ** 2)

    fn_c = make_dp_train_grads(loss_fn, mesh, compress=True)
    fn_u = make_dp_train_grads(loss_fn, mesh, compress=False)
    bufs = init_error_bufs(w0, WORLD, mesh)
    rows = bufs.to_local().shape[0]
    w_c = w_u = w0
    top = 0.0                  # the largest |gradient|, for the int8 step
    for _ in range(job["ef"]["steps"]):
        _, g_c, bufs = fn_c(w_c, (x, y), bufs)
        _, g_u, _ = fn_u(w_u, (x, y), None)
        top = max(top, float(g_u.abs().max()), float(g_c.abs().max()))
        w_c = w_c - 0.05 * g_c
        w_u = w_u - 0.05 * g_u
    if rank == 0:
        np.savez(job["ef"]["out"], w_c=w_c.numpy(), w_u=w_u.numpy(),
                 max_abs_grad=top, rows=rows, global_rows=bufs.shape[0],
                 l_c=float(loss_fn(w_c, (x, y))),
                 l_u=float(loss_fn(w_u, (x, y))))


def run_remesh(job, mesh, rank):
    from repro_torch.ckpt.manager import CheckpointManager, reshard_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.optimizer import tree_leaves

    r = job["remesh"]
    cfg = get_smoke_config(r["arch"])
    source = torch.load(r["params"], weights_only=True)
    params, state, _ = _placed(cfg, mesh, r["params"])
    mgr = CheckpointManager(r["dir"], cfg=cfg)
    mgr.save(1, params, state, through_pfs=False)
    out = {}
    for shape in ((WORLD, 1), (1, WORLD)):
        new = make_test_mesh(*shape, device_type="cpu")
        step, restored, opt, _ = mgr.restore_latest(params, state)
        specs = shd.validate_pspecs(shd.param_pspecs(restored), restored,
                                    new)
        moved = reshard_checkpoint(restored, new, specs)
        out["x".join(map(str, shape))] = dict(
            step=step,
            params=all(torch.equal(a.full_tensor(), b) for a, b in zip(
                tree_leaves(moved), tree_leaves(source))),
            moments_zero=all(not bool(t.any()) for t in tree_leaves(opt["m"])),
            placements=sorted({str(t.placements) for t in tree_leaves(moved)}))
    return out


def run_serve(case, rank):
    """Prefill ``case``'s prompts and decode ``steps`` greedy tokens on
    its mesh; rank 0 saves every step's logits (prefill first)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.constrain import full, is_dtensor
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import place_on_mesh
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    from repro_torch.utils.roofline import CollectiveRecorder

    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              param_dtype="float32")
    mesh = make_test_mesh(*case["mesh"], device_type="cpu")
    params = torch.load(case["params"], weights_only=True)
    prompts = torch.as_tensor(np.load(case["prompts"]))
    params, prompts, _ = place_on_mesh(params, prompts, None, mesh)
    prefill = make_prefill_step(cfg, case["max_len"])
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, prompts)
    out, info = [full(logits)], {}
    pos = prompts.shape[1]
    for i in range(case["steps"]):
        tok = logits.argmax(dim=-1)
        if i == 0 and case.get("record"):
            rec = CollectiveRecorder()
            with rec:
                logits, cache = decode(params, tok, cache, pos + i)
            kv = [c["k"] for c in cache if "k" in c]
            info = dict(records=[r[:2] for r in rec.stats.records],
                        cache_shard_bytes=min(
                            (t.to_local().numel() * t.element_size()
                             for t in kv), default=None),
                        cache_placements=str(kv[0].placements)
                        if kv and is_dtensor(kv[0]) else None)
        else:
            logits, cache = decode(params, tok, cache, pos + i)
        out.append(full(logits))
    if rank == 0:
        np.savez(case["out"], *[t.numpy() for t in out])
    return info


def run_raise(job, rank):
    """The rank ``job["raise_on"]`` raises; the others wait for it in an
    all-reduce, which only the guard's ending of the run lets go."""
    if rank == job["raise_on"]:
        raise RuntimeError(f"rank {rank} raises on purpose")
    dist.all_reduce(torch.ones(1))


def rank_main(rank, job):
    from repro_torch.launch.mesh import end_run_on_error

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=job["init"], rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    with end_run_on_error(rank):
        rank_work(rank, job)


def rank_work(rank, job):
    out = {}
    try:
        from repro_torch.launch.mesh import make_test_mesh
        if "raise_on" in job:
            run_raise(job, rank)
        try:
            make_test_mesh(2, 1, device_type="cpu")
            out["wrong_size"] = "no error"
        except ValueError as e:
            out["wrong_size"] = str(e)
        pods = make_test_mesh(1, 2, multi_pod=True, device_type="cpu")
        out["multi_pod"] = [list(pods.mesh_dim_names), list(pods.shape)]
        mesh = make_test_mesh(2, 2, device_type="cpu")
        if job.get("zero1"):
            out["zero1"] = run_zero1(job["zero1"], mesh, job)
        if job.get("ef"):
            run_ef(job, rank)
        if job.get("remesh"):
            out["remesh"] = run_remesh(job, mesh, rank)
        out["cases"] = {c["name"]: run_case(c, mesh, job, rank)
                        for c in job.get("cases", ())}
        out["serve"] = {c["name"]: run_serve(c, rank)
                        for c in job.get("serve", ())}
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        if rank == 0:
            with open(job["result"], "w") as f:
                json.dump(out, f)


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        job = json.load(f)
    mp.spawn(rank_main, args=(job,), nprocs=WORLD, join=True)
