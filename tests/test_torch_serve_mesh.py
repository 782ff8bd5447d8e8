"""Sharded serving and the head-sharding repair, on four CPU ranks.

Four ``gloo`` processes (``tests/torch_mesh_ranks.py``) run the port's
sharded steps in float32 on smoke configs, and each result is held
against the same step of the unsharded port in this process:

(a) The repair of attention's head sharding: the sharded train step of
    gemma2-2b and stablelm-12b on a 1 x 4 mesh (4 q heads, 2 kv heads:
    the kv heads do not divide 'model'; before the repair the reshape to
    heads raised "Cannot unflatten unevenly sharded tensor"): the first
    batch's gradients leaf by leaf (each against its norm), the loss and
    grad norm of two steps and the parameters after them, within 1e-5.
(b) Sharded prefill and 8 greedy decode steps of gemma2-2b,
    recurrentgemma-9b, falcon-mamba-7b, stablelm-12b and olmoe-1b-7b on
    2 x 2 and 1 x 4 (batch 4) and on 4 x 1 with batch 1, whose attention
    caches shard their sequence over 'data' (``shard_seq``), once with a
    window across two slices and once ("4x1-tail") with every local
    layer's keys on the last rank alone: every step's logits within 1e-5
    and the greedy tokens identical.
(c) On 4 x 1, the collectives of one decode step: none of an attention
    cache shard's size; an attention layer's only collectives are the
    two all-reduces that merge the ranks' partial softmaxes (the row
    log-sum-exp's max, then the weighted outputs and weights).
(d) A rank that raises ends the run: rank 3 raises while ranks 0-2 wait
    for it in an all-reduce; the run ends non-zero within a minute of
    the raise, with the rank and its traceback printed.

The unsharded port is held to the reference by ``test_torch_lm.py`` and
``test_torch_lm_families.py``.  The reference's own sharded steps do not
lower under the installed jax, so sharded against unsharded is the bar
here.  Torch only.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.steps import (make_decode_step,  # noqa: E402
                                     make_prefill_step, make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_mesh_ranks.py"
TIMEOUT_S = 600
TOL = 1e-5

TRAIN_ARCHS = ("gemma2-2b", "stablelm-12b")
B, S, STEPS = 4, 32, 2
OPT = dict(peak_lr=1e-2, min_lr=1e-3, warmup_steps=1, total_steps=4,
           clip_norm=0.5, eps=1e-3)

SERVE_ARCHS = ("gemma2-2b", "recurrentgemma-9b", "falcon-mamba-7b",
               "stablelm-12b", "olmoe-1b-7b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1), "4x1-tail": (4, 1)}
PROMPT, MAX_LEN, DECODE = 16, 32, 8      # a 16-window spans two slices
# "4x1-tail", the four-card layout of gemma2-2b at batch 1 (a prompt of
# MAX_LEN - DECODE): at every decode step a 16-key window lies wholly in
# the last rank's 32-position slice, so ranks 0-2 hold no live key of a
# local layer and merge only what rank 3 gives
TAIL_PROMPT, TAIL_MAX_LEN = 120, 128


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32")


def _params(arch, seed=0):
    return lm.init_params(_cfg(arch), torch.Generator().manual_seed(seed),
                          "cpu")


def _batch_size(mesh):
    return 1 if mesh.startswith("4x1") else 4   # batch 1: the sequence shards


def _lengths(mesh):
    """(prompt tokens, cache positions)."""
    return (TAIL_PROMPT, TAIL_MAX_LEN) if mesh == "4x1-tail" else (PROMPT,
                                                                   MAX_LEN)


def _prompts(arch, mesh):
    return np.random.default_rng(7).integers(
        0, _cfg(arch).vocab_size, (_batch_size(mesh), _lengths(mesh)[0]))


def _tokens(arch, seed):
    return np.random.default_rng(seed).integers(
        0, _cfg(arch).vocab_size, (B, S)).astype(np.int64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case in one run of four processes."""
    d = tmp_path_factory.mktemp("serve_mesh")
    cases, serve = [], []
    for arch in TRAIN_ARCHS:
        name = f"{arch}-train"
        torch.save(_params(arch), d / f"{name}.pt")
        np.save(d / f"{name}.npy",
                np.stack([_tokens(arch, 10 + i) for i in range(STEPS)]))
        cases.append(dict(name=name, arch=arch, dtype="float32",
                          grad_accum=1, mesh=[1, 4],
                          params=str(d / f"{name}.pt"),
                          batches=str(d / f"{name}.npy"),
                          out=str(d / f"{name}.npz")))
    for arch in SERVE_ARCHS:
        torch.save(_params(arch), d / f"{arch}.pt")
        for mesh, shape in MESHES.items():
            name = f"{arch}-{mesh}"
            np.save(d / f"{name}.prompts.npy", _prompts(arch, mesh))
            serve.append(dict(name=name, arch=arch, mesh=list(shape),
                              params=str(d / f"{arch}.pt"),
                              prompts=str(d / f"{name}.prompts.npy"),
                              max_len=_lengths(mesh)[1], steps=DECODE,
                              record=mesh == "4x1",
                              out=str(d / f"{name}.npz")))
    job = dict(init=f"file://{d}/rendezvous", result=str(d / "result.json"),
               opt=OPT, cases=cases, serve=serve)
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


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(path) -> list:
    with np.load(path) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _rel(a, b) -> float:
    d = float(np.linalg.norm((a - b).ravel()))
    n = float(np.linalg.norm(b.ravel()))
    return d / n if n else (0.0 if d == 0 else float("inf"))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_at_1x4_matches_unsharded(ranks, arch):
    from torch_mesh_ranks import grads_of

    cfg, name = _cfg(arch), f"{arch}-train"
    t = torch.as_tensor(_tokens(arch, 10))
    want_grads = grads_of(cfg, _params(arch), {"tokens": t, "labels": t})
    grads = _npz(ranks["dir"] / f"{name}.grads.npz")
    assert len(grads) == len(want_grads)
    worst = max(_rel(a, b.numpy()) for a, b in zip(grads, want_grads))
    assert worst <= TOL, worst

    params = _params(arch)
    state = opt.init_opt_state(params)
    step = make_train_step(cfg, opt.AdamWConfig(**OPT))
    for i, got in enumerate(ranks["cases"][name]):
        t = torch.as_tensor(_tokens(arch, 10 + i))
        params, state, m = step(params, state, {"tokens": t, "labels": t})
        assert got["lr"] == float(m["lr"])
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=TOL)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                 rel=TOL)
    leaves = _npz(ranks["dir"] / f"{name}.npz")
    for a, b in zip(leaves, opt.tree_leaves(params)):
        b = b.numpy()
        assert float(np.abs(a - b).max()) <= TOL * max(
            float(np.abs(b).max()), 1e-30), a.shape


def _unsharded_serve(arch, mesh) -> list:
    cfg = _cfg(arch)
    params = _params(arch)
    prompt, max_len = _lengths(mesh)
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    with torch.inference_mode():
        logits, cache = prefill(params, torch.as_tensor(_prompts(arch, mesh)))
        out = [logits]
        for i in range(DECODE):
            logits, cache = decode(params, logits.argmax(dim=-1), cache,
                                   prompt + i)
            out.append(logits)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_matches_unsharded(ranks, arch, mesh):
    got = _npz(ranks["dir"] / f"{arch}-{mesh}.npz")
    want = _unsharded_serve(arch, mesh)
    assert len(got) == len(want) == DECODE + 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err = float(np.abs(a - b).max())
        assert err <= TOL, (i, err)
        assert np.array_equal(a.argmax(-1), b.argmax(-1)), i


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_shard_seq_decode_moves_no_cache(ranks, arch):
    info = ranks["serve"][f"{arch}-4x1"]
    cfg = _cfg(arch)
    records = info["records"]
    kinds = set(cfg.layer_types()) & {"attn", "attn_local", "moe"}
    if not kinds:          # no attention cache: nothing to merge
        assert info["cache_placements"] is None
        assert all(k != "all-gather" for k, _ in records), records
        return
    assert "Shard(dim=2)" in info["cache_placements"]
    assert max(n for _, n in records) < info["cache_shard_bytes"], records
    hq, dh = max(cfg.n_heads_pad, cfg.n_heads), cfg.head_dim_
    stats, merged = 4 * hq, 4 * hq * (dh + 1)   # batch 1, float32
    n_attn = sum(k in kinds for k in cfg.layer_types())
    merges = [r for r in records if r == ["all-reduce", stats]
              or r == ["all-reduce", merged]]
    assert len(merges) == 2 * n_attn, records
    assert not [r for r in records if r[0] == "all-gather"], records


def test_a_rank_that_raises_ends_the_run(tmp_path):
    job = dict(init=f"file://{tmp_path}/rendezvous",
               result=str(tmp_path / "result.json"), raise_on=3)
    (tmp_path / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(RANKS),
                           str(tmp_path / "job.json")], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    ended = time.time()
    assert proc.returncode != 0
    raised = re.search(r"rank 3 raised at unix time ([0-9.]+); ending "
                       r"every rank", proc.stderr)
    assert raised, proc.stderr[-4000:]
    assert "RuntimeError: rank 3 raises on purpose" in proc.stderr
    # the group's timeout is 120 s: only the guard ends ranks 0-2 sooner
    assert ended - float(raised.group(1)) < 60.0
