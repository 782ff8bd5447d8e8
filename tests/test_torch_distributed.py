"""The port's distributed pieces (sharding rules, ZeRO-1, the sharded train
step, EF-int8 compressed reduction, re-mesh restore) against the
reference's, on the CPU.

(a) Spec parity, in process: ``param_pspecs``, ``validate_pspecs``,
    ``zero1_pspecs`` and ``cache_pspecs`` of all ten full configs equal
    the reference's on (2, 4), (16, 16) and (2, 16, 16) stand-in meshes
    (the reference's stacked ``n_rep`` axis dropped, its cache k/v dims 1
    and 2 swapped), the port's side on ``meta`` tensors.  Two known
    differences are asserted as lists: the ZeRO-1 leaves whose reference
    spec shards the stacked axis (the port's per-layer leaf has none),
    and Qwen2-MoE's shared-expert leaves, which the reference's ``moe``
    branch catches before its ``shared`` branch (ROADMAP Queue 3).
(b) The sharded train step on a 2 x 2 ``gloo`` mesh (four processes,
    ``tests/torch_mesh_ranks.py``), ``grad_accum`` 1 and 2, stablelm-12b
    (the reference's own case, batch 4 x 32) and one smoke config per
    layer kind, against the port's unsharded step: the first batch's
    gradients leaf by leaf (each against its norm), the loss and grad
    norm of two steps and the parameters after them, at :data:`BARS`
    (float32 1e-5; bf16 bars a fault fails), and the first loss against
    the reference's ``lm.loss_fn``.  The gradients reach AdamW
    data-partial and are reduce-scattered onto the ZeRO-1 moments, with
    no all-reduce over 'data'.
(c) ``quantize_int8``, ``ef_compress`` and ``dequantize`` bit-equal to
    the reference's, exact halves included; the reference test's 30-step
    EF loop at 4 ranks against the reference's ``make_dp_train_grads`` on
    4 forced host devices (a child process, jitted): the plain run's
    weights within 1e-6 relative; the compressed run's too, but for at
    most two elements, each within one quantization unit (lr x the
    int8 step over the ranks): the two packages' float32 matmuls sum in
    other orders, and a gradient element within an ulp of a half step
    rounds to the other int8 (error feedback then carries the
    difference, so it does not grow); ``l_c < 1.05 l_u + 1e-3`` in
    both; each rank holds one row of the error buffer.
(d) Re-mesh: a save under (2, 2) restored onto (4, 1) and (1, 4), every
    leaf exact.
(e) Single-card neutrality: ``constrain`` on a plain tensor and with no
    mesh returns its input; ``model_axis_size()`` is 0.

Every multi-rank run is a subprocess with a ``file://`` rendezvous under
``tmp_path`` and timeouts on both the process group and the subprocess.
"""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.constrain import (constrain,  # noqa: E402
                                               model_axis_size, use_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from torch_mesh_ranks import grads_of  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_mesh_ranks.py"
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

# ZeRO-1 leaves (reference layout) whose reference spec shards the
# stacked n_rep axis; the port's per-layer leaf has no such axis
_STACKED_16 = [
    "qwen1.5-32b:stack/0/attn/bk", "qwen1.5-32b:stack/0/attn/bq",
    "qwen1.5-32b:stack/0/attn/bv", "falcon-mamba-7b:stack/0/mamba/A_log",
    "falcon-mamba-7b:stack/0/mamba/D", "falcon-mamba-7b:stack/0/mamba/conv_w",
    "falcon-mamba-7b:stack/0/mamba/dt_bias"]
_SHARED = ["qwen2-moe-a2.7b:stack/0/moe/shared/down",
           "qwen2-moe-a2.7b:stack/0/moe/shared/gate",
           "qwen2-moe-a2.7b:stack/0/moe/shared/up"]
ZERO1_STACKED = {
    "2x4": sorted(_STACKED_16 + _SHARED + [
        "starcoder2-15b:stack/0/attn/bk", "starcoder2-15b:stack/0/attn/bq",
        "starcoder2-15b:stack/0/attn/bv", "qwen2-moe-a2.7b:stack/0/attn/bk",
        "qwen2-moe-a2.7b:stack/0/attn/bq", "qwen2-moe-a2.7b:stack/0/attn/bv",
        "recurrentgemma-9b:stack/0/rec/ba", "recurrentgemma-9b:stack/0/rec/bx",
        "recurrentgemma-9b:stack/0/rec/conv_w",
        "recurrentgemma-9b:stack/0/rec/lam",
        "recurrentgemma-9b:stack/1/rec/ba", "recurrentgemma-9b:stack/1/rec/bx",
        "recurrentgemma-9b:stack/1/rec/conv_w",
        "recurrentgemma-9b:stack/1/rec/lam"]),
    "16x16": sorted(_STACKED_16),
    "2x16x16": sorted(_STACKED_16)}


class StandInMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _key(entry):
    return str(getattr(entry, "key", getattr(entry, "idx", entry)))


def ref_flat(spec_tree) -> dict:
    """Reference spec tree -> {"stack/0/attn/wq": tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(_key(e) for e in path): tuple(s) for path, s in flat}


def port_flat(cfg, spec_tree, prefix="") -> dict:
    """Port spec tree -> the reference's paths: layer j is
    ``stack/(j % n_pat)`` below ``n_rep * n_pat``, ``tail/(j - n_stack)``
    after; several port layers share one reference path (and must agree
    on it)."""
    n_pat = len(cfg.layer_pattern)
    n_stack = cfg.n_rep * n_pat
    out: dict = {}

    def walk(node, path):
        if isinstance(node, shd.PartitionSpec):
            spec = tuple(node)
            assert out.setdefault(path, spec) == spec, (path, spec)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            for j, v in enumerate(node):
                walk(v, (f"stack/{j % n_pat}" if j < n_stack
                         else f"tail/{j - n_stack}") if path == "layers"
                     else f"{path}/{j}")
    walk(spec_tree, prefix)
    return out


def _unstacked(path: str, spec: tuple) -> tuple:
    return spec[1:] if path.startswith("stack/") else spec


def _ref_and_port_specs(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    ref_mesh = StandInMesh(shape, names)
    sizes = dict(zip(names, shape))
    ap = ref_lm.abstract_params(ref_config(arch))
    rp = ref_shd.param_pspecs(ap)
    ref = {"param": ref_flat(rp),
           "valid": ref_flat(ref_shd.validate_pspecs(rp, ap, ref_mesh)),
           "zero1": ref_flat(ref_shd.validate_pspecs(
               ref_shd.zero1_pspecs(ap, rp, ref_mesh), ap, ref_mesh))}
    cfg = get_config(arch)
    tp = lm.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in opt.tree_leaves(tp))
    pp = shd.param_pspecs(tp)
    port = {"param": port_flat(cfg, pp),
            "valid": port_flat(cfg, shd.validate_pspecs(pp, tp, sizes)),
            "zero1": port_flat(cfg, shd.validate_pspecs(
                shd.zero1_pspecs(tp, pp, sizes), tp, sizes))}
    return ref, port


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_reference(arch, mesh_name):
    ref, port = _ref_and_port_specs(arch, mesh_name)
    assert set(ref["param"]) == set(port["param"])
    for path in ref["param"]:
        shared = "/moe/shared/" in path
        for kind in ("param", "valid"):
            want = _unstacked(path, ref[kind][path])
            if shared:       # the dense rule the reference's branch states
                name = path.rsplit("/", 1)[1]
                want = ref_shd._RULES[name]
                if kind == "valid":
                    continue
            else:
                assert ref[kind][path][:1] in ((None,), ()) or not \
                    path.startswith("stack/"), (kind, path)
            assert port[kind][path] == want, (kind, path, port[kind][path])
    known = [f"{arch}:{p}" for p, s in ref["zero1"].items()
             if p.startswith("stack/") and s[0] is not None]
    assert known == [k for k in ZERO1_STACKED[mesh_name]
                     if k.startswith(arch + ":")], known
    for path, spec in ref["zero1"].items():
        if f"{arch}:{path}" in known or "/moe/shared/" in path:
            continue
        assert port["zero1"][path] == _unstacked(path, spec), (
            path, port["zero1"][path], spec)


def test_zero1_known_lists_have_the_counted_sizes():
    assert [len(ZERO1_STACKED[m]) for m in MESHES] == [24, 7, 7]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name):
    """Both modes; the port's k/v are (B, Hkv, S, Dh)."""
    shape, names = MESHES[mesh_name]
    rcfg, cfg = ref_config(arch), get_config(arch)
    rcache = jax.eval_shape(lambda: ref_lm.init_cache(rcfg, 2, 64))
    cache = lm.init_cache(cfg, 2, 64, torch.device("meta"))
    for shard_seq in (False, True):
        ref = ref_flat(ref_shd.cache_pspecs(rcfg, rcache,
                                            StandInMesh(shape, names),
                                            shard_seq=shard_seq))
        port = port_flat(cfg, {"layers": shd.cache_pspecs(
            cfg, cache, dict(zip(names, shape)), shard_seq=shard_seq)})
        assert set(ref) == set(port)
        for path, spec in ref.items():
            want = list(_unstacked(path, spec))
            if path.rsplit("/", 1)[1] in ("k", "v"):
                want[1], want[2] = want[2], want[1]
            assert port[path] == tuple(want), (shard_seq, path, port[path])


# ---------------------------------------------------------------------- #
# (b), (c), (d): one four-rank run
# ---------------------------------------------------------------------- #
TRAIN_ARCHS = ("stablelm-12b", "gemma2-2b", "recurrentgemma-9b",
               "falcon-mamba-7b", "olmoe-1b-7b")
CASES = ([(a, "float32", g) for a in TRAIN_ARCHS for g in (1, 2)]
         + [("musicgen-large", "float32", 1),       # the codebook head
            ("stablelm-12b", "bfloat16", 2), ("gemma2-2b", "bfloat16", 1)])
B, S, STEPS = 4, 32, 2
OPT = dict(peak_lr=1e-2, min_lr=1e-3, warmup_steps=1, total_steps=4,
           clip_norm=0.5, eps=1e-3)
EF_STEPS = 30
# the sharded step against the unsharded one.  float32: the loss and
# grad norm relative, every parameter against its leaf's largest
# |value|, and every first-batch gradient leaf against its norm.  bf16,
# with bars a fault cannot pass: the loss absolute (a step that updates
# nothing is ~0.11 off at step 2), the grad norm relative, each gradient
# leaf against its norm (measured up to 0.032; a leaf left partial over
# the two data ranks, or a half batch, is ~0.5 off), and the parameters'
# distance after the two steps over the plain run's own update
# (measured 0.046; no update, or one of another gradient, is ~1); the
# first loss against the reference's, relative (bf16: measured 9e-5)
BARS = {"float32": dict(loss=1e-5, grad_norm=1e-5, grad=1e-5, param=1e-5,
                        ref_loss=1e-5),
        "bfloat16": dict(loss=1e-2, grad_norm=1e-2, grad=0.1, update=0.2,
                         ref_loss=1e-3)}
TIMEOUT_S = 600


def _configs(arch, dtype):
    return (dataclasses.replace(ref_smoke(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype):
    rcfg, _ = _configs(arch, dtype)
    return jax.tree.map(np.asarray, ref_lm.init_params(
        rcfg, jax.random.PRNGKey(0)))


def _tokens(cfg, seed):
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int64)


def _name(arch, dtype, grad_accum):
    return f"{arch}-{dtype}-{grad_accum}"


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every multi-rank case in one run of four processes."""
    d = tmp_path_factory.mktemp("mesh")
    cases = []
    for arch, dtype, ga in CASES:
        _, cfg = _configs(arch, dtype)
        name = _name(arch, dtype, ga)
        torch.save(lm_params_from_numpy(cfg, _ref_params(arch, dtype), "cpu"),
                   d / f"{name}.pt")
        np.save(d / f"{name}.npy",
                np.stack([_tokens(cfg, 10 + i) for i in range(STEPS)]))
        cases.append(dict(name=name, arch=arch, dtype=dtype, grad_accum=ga,
                          params=str(d / f"{name}.pt"),
                          batches=str(d / f"{name}.npy"),
                          out=str(d / f"{name}.npz")))
    first = cases[2]                      # gemma2-2b float32
    job = dict(init=f"file://{d}/rendezvous", result=str(d / "result.json"),
               opt=OPT, cases=cases, zero1=first,
               ef=dict(steps=EF_STEPS, out=str(d / "ef.npz")),
               remesh=dict(arch="gemma2-2b", params=first["params"],
                           dir=str(d / "ckpt")))
    (d / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(RANKS), str(d / "job.json")],
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    out = json.loads((d / "result.json").read_text()) \
        if (d / "result.json").exists() else {}
    assert proc.returncode == 0 and "error" not in out, (
        out.get("error"), proc.stderr[-4000:])
    out["dir"] = d
    return out


def _unsharded(arch, dtype, grad_accum):
    rcfg, cfg = _configs(arch, dtype)
    params = lm_params_from_numpy(cfg, _ref_params(arch, dtype), "cpu")
    state = opt.init_opt_state(params)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT), grad_accum)
    metrics = []
    for i in range(STEPS):
        t = torch.as_tensor(_tokens(cfg, 10 + i))
        params, state, m = step(params, state, {"tokens": t, "labels": t})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [p.float().numpy() for p in opt.tree_leaves(params)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unsharded_grads(arch, dtype):
    _, cfg = _configs(arch, dtype)
    params = lm_params_from_numpy(cfg, _ref_params(arch, dtype), "cpu")
    t = torch.as_tensor(_tokens(cfg, 10))
    return [g.numpy() for g in grads_of(cfg, params,
                                        {"tokens": t, "labels": t})]


def _rel(a, b) -> float:
    """``a``'s distance from ``b`` over ``b``'s norm (0 when both are 0)."""
    d = float(np.linalg.norm((a - b).ravel()))
    n = float(np.linalg.norm(b.ravel()))
    return d / n if n else (0.0 if d == 0 else float("inf"))


@pytest.mark.parametrize("arch,dtype,grad_accum", CASES)
def test_sharded_train_step_matches_unsharded(mesh_run, arch, dtype,
                                              grad_accum):
    bar = BARS[dtype]
    name = _name(arch, dtype, grad_accum)
    got = mesh_run["cases"][name]
    want, want_params = _unsharded(arch, dtype, grad_accum)
    with np.load(mesh_run["dir"] / f"{name}.grads.npz") as z:
        grads = [z[f"arr_{i}"] for i in range(len(z.files))]
    want_grads = _unsharded_grads(arch, dtype)
    assert len(grads) == len(want_grads)
    worst = max(_rel(a, b) for a, b in zip(grads, want_grads))
    assert worst <= bar["grad"], worst
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["lr"] == w["lr"]
        assert abs(g["loss"] - w["loss"]) <= bar["loss"] * (
            abs(w["loss"]) if dtype == "float32" else 1.0), (i, g, w)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"],
                                               rel=bar["grad_norm"]), (i, g, w)
    with np.load(mesh_run["dir"] / f"{name}.npz") as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    assert len(leaves) == len(want_params)
    if dtype == "float32":
        for i, (a, b) in enumerate(zip(leaves, want_params)):
            assert float(np.abs(a - b).max()) <= bar["param"] * max(
                float(np.abs(b).max()), 1e-30), (i, a.shape)
    else:      # the distance over the plain run's own update
        _, cfg = _configs(arch, dtype)
        init = opt.tree_leaves(lm_params_from_numpy(
            cfg, _ref_params(arch, dtype), "cpu"))
        moved = sum(float(np.sum((b - c.float().numpy()) ** 2))
                    for b, c in zip(want_params, init))
        apart = sum(float(np.sum((a - b) ** 2))
                    for a, b in zip(leaves, want_params))
        assert (apart / moved) ** 0.5 <= bar["update"], (apart, moved)
    if grad_accum == 1:   # the first loss is the reference's loss_fn's
        rcfg, _ = _configs(arch, dtype)
        t = jnp.asarray(_tokens(rcfg, 10))
        ref = float(ref_lm.loss_fn(jax.tree.map(jnp.asarray,
                                                _ref_params(arch, dtype)),
                                   {"tokens": t, "labels": t}, rcfg))
        assert got[0]["loss"] == pytest.approx(ref, rel=bar["ref_loss"])


def test_zero1_reduce_scatters_partial_gradients(mesh_run):
    z = mesh_run["zero1"]
    assert z["laid_as_moments"]
    # every gradient leaves the backward pass partial over 'data' ...
    assert z["partial_on_data"] == z["n_leaves"]
    # ... and over 'data' each one whose moment is data-sharded is
    # reduce-scattered, only the others (moments replicated) all-reduced
    assert z["partial_to_shard"] > 10
    assert z["counts"].get("reduce_scatter_tensor", 0) == z[
        "partial_to_shard"]
    assert z["counts"].get("all_reduce", 0) == z["n_leaves"] - z[
        "partial_to_shard"]
    assert z["counts"].get("all_gather_into_tensor", 0) == 0


def test_mesh_of_the_wrong_size_raises(mesh_run):
    assert "needs 2 processes, the group has 4" in mesh_run["wrong_size"]


def test_multi_pod_mesh_names_its_axes(mesh_run):
    assert mesh_run["multi_pod"] == [["pod", "data", "model"], [2, 1, 2]]


@pytest.mark.parametrize("onto", ["4x1", "1x4"])
def test_remesh_restores_every_leaf_exactly(mesh_run, onto):
    r = mesh_run["remesh"][onto]
    assert r["step"] == 1 and r["params"] and r["moments_zero"]
    assert len(r["placements"]) > 1      # really sharded on the new mesh


# ---------------------------------------------------------------------- #
# (c) compression
# ---------------------------------------------------------------------- #
def _arrays():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(64, 33)).astype(np.float32) * s
          for s in (1e-3, 1.0, 7.0)]
    # max |x| 127 -> scale 1 (+1e-12 vanishes in float32): exact halves
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -126.5, 0.0], np.float32)
    return xs + [halves]


@pytest.mark.parametrize("i", range(4))
def test_quantize_and_ef_bit_equal_reference(i):
    x = _arrays()[i]
    e = np.random.default_rng(i).normal(size=x.shape).astype(np.float32) \
        * 1e-2
    rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.as_tensor(x))
    assert np.array_equal(np.asarray(rq), q.numpy())
    assert np.float32(rs) == s.numpy()
    assert np.array_equal(np.asarray(ref_comp.dequantize(rq, rs)),
                          comp.dequantize(q, s).numpy())
    rq, rs, re = ref_comp.ef_compress(jnp.asarray(x), jnp.asarray(e))
    q, s, ne = comp.ef_compress(torch.as_tensor(x), torch.as_tensor(e))
    assert np.array_equal(np.asarray(rq), q.numpy())
    assert np.float32(rs) == s.numpy()
    assert np.array_equal(np.asarray(re), ne.numpy())


def test_wire_bytes_and_error_bufs_match_reference():
    tree = {"a": np.zeros((3, 5), np.float32), "b": [np.zeros(7, np.float32)]}
    ttree = {"a": torch.zeros(3, 5), "b": [torch.zeros(7)]}
    for c in (True, False):
        assert comp.wire_bytes(ttree, c) == ref_comp.wire_bytes(tree, c)
    bufs = comp.init_error_bufs(ttree, 4)
    rbufs = ref_comp.init_error_bufs(jax.tree.map(jnp.asarray, tree), 4)
    assert bufs["a"].shape == rbufs["a"].shape == (4, 3, 5)
    assert bufs["b"][0].shape == rbufs["b"][0].shape == (4, 7)


_REF_EF = r"""
import jax, jax.numpy as jnp, numpy as np, sys
from repro.distributed.compression import init_error_bufs, make_dp_train_grads
mesh = jax.make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
W = jnp.asarray(rng.normal(size=(16, 4)), jnp.float32)
X = jnp.asarray(rng.normal(size=(64, 16)), jnp.float32)
Y = jnp.asarray(rng.normal(size=(64, 4)), jnp.float32)

def loss_fn(w, batch):
    x, y = batch
    return jnp.mean((x @ w - y) ** 2)

fn_c = jax.jit(make_dp_train_grads(loss_fn, mesh, compress=True))
fn_u = jax.jit(make_dp_train_grads(loss_fn, mesh, compress=False))
bufs = init_error_bufs(W, 4)
w_c = w_u = W
for i in range(int(sys.argv[2])):
    with mesh:
        _, g_c, bufs = fn_c(w_c, (X, Y), bufs)
        _, g_u = fn_u(w_u, (X, Y), init_error_bufs(W, 4))[:2]
    w_c = w_c - 0.05 * g_c
    w_u = w_u - 0.05 * g_u
np.savez(sys.argv[1], w_c=np.asarray(w_c), w_u=np.asarray(w_u),
         l_c=float(loss_fn(w_c, (X, Y))), l_u=float(loss_fn(w_u, (X, Y))))
"""


def test_ef_loop_matches_reference_at_four_ranks(mesh_run, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = tmp_path / "ref_ef.npz"
    proc = subprocess.run([sys.executable, "-c", _REF_EF, str(out),
                           str(EF_STEPS)], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as r, np.load(mesh_run["dir"] / "ef.npz") as p:
        # each rank holds one row of the (4, ...) error buffer
        assert int(p["rows"]) == 1 and int(p["global_rows"]) == 4
        np.testing.assert_allclose(p["w_u"], r["w_u"], rtol=1e-6, atol=1e-6)
        off = np.abs(p["w_c"] - r["w_c"]) > 1e-6 * (1 + np.abs(r["w_c"]))
        unit = 0.05 * float(p["max_abs_grad"]) / 127.0 / 4
        assert off.sum() <= 2, off.sum()
        assert float(np.abs(p["w_c"] - r["w_c"]).max()) <= unit * 1.01, (
            np.abs(p["w_c"] - r["w_c"]).max(), unit)
        assert float(p["l_c"]) < 1.05 * float(p["l_u"]) + 1e-3
        assert float(r["l_c"]) < 1.05 * float(r["l_u"]) + 1e-3


# ---------------------------------------------------------------------- #
# (e) single-card neutrality
# ---------------------------------------------------------------------- #
def test_constrain_is_neutral_without_mesh_or_dtensor():
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, "dp", "model") is x
    assert model_axis_size() == 0
    sentinel = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                                 "size": lambda self, i: (2, 4)[i]})()
    with use_mesh(sentinel):
        assert constrain(x, "dp", "model") is x      # a plain tensor
        assert model_axis_size() == 4
    assert model_axis_size() == 0


def test_single_card_step_unchanged_by_the_mesh_code():
    """The plain train step takes none of the mesh paths: two steps from
    the same tree are bit-equal with and without a mesh context open
    around them (plain tensors pass ``constrain`` untouched)."""
    _, cfg = _configs("gemma2-2b", "float32")
    runs = []
    for ctx in (False, True):
        params = lm_params_from_numpy(
            cfg, _ref_params("gemma2-2b", "float32"), "cpu")
        state = opt.init_opt_state(params)
        step = make_train_step(cfg, opt.AdamWConfig(**OPT))
        sentinel = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                                     "size": lambda self, i: 2})()
        t = torch.as_tensor(_tokens(cfg, 10))
        for _ in range(2):
            if ctx:
                with use_mesh(sentinel):
                    params, state, m = step(params, state,
                                            {"tokens": t, "labels": t})
            else:
                params, state, m = step(params, state,
                                        {"tokens": t, "labels": t})
        runs.append((float(m["loss"]), opt.tree_leaves(params)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_compressed_psum_keeps_every_leaf_in_place(tmp_path):
    """On a one-rank group, a tree whose dict keys are not in sorted
    order: every reduced leaf and error buffer lands on its own key."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        rng = np.random.default_rng(5)
        f32 = torch.float32
        tree = {"z": torch.tensor(rng.normal(size=(3, 4)), dtype=f32),
                "a": [torch.tensor(rng.normal(size=7), dtype=f32)]}
        bufs = {"z": torch.zeros(3, 4), "a": [torch.zeros(7)]}
        got, new = comp.compressed_psum(tree, bufs)
        for g, e, x in ((got["z"], new["z"], tree["z"]),
                        (got["a"][0], new["a"][0], tree["a"][0])):
            q, s, ne = comp.ef_compress(x, torch.zeros_like(x))
            assert torch.equal(g, comp.dequantize(q, s))
            assert torch.equal(e, ne)
    finally:
        dist.destroy_process_group()
