"""The port's LM training path with DIAL in its data path, against the
reference's, at smoke size on the CPU.

The same inputs (numpy, from a seed) and the same parameters (the
reference's ``init_params``, converted) go through both packages:

- ``chunked_attention`` and the three training blocks (attention,
  RG-LRU, Mamba): values and the gradients of a seeded projection of
  the output, for the inputs and every parameter, float32, within 1e-5
  of the largest |value| (the RG-LRU's associative scan and the
  chunked softmax sum in other orders);
- ``loss_fn`` and every gradient leaf, gemma2, recurrentgemma and
  falcon-mamba SMOKE in float32: the loss within 1e-5 relative, each
  leaf within 1e-5 of its largest |value|; in bf16 the loss within 2e-2
  (bf16 rounds at other places in the two packages' matmuls);
- ``make_train_step`` for 3 steps, ``grad_accum`` 1 and 2: loss, grad
  norm and lr within 1e-5 relative, every parameter within 1e-5 of its
  leaf's largest |value| after the last step (the reference's decay
  set included);
- the decay rule on recurrentgemma's tail leaves against its stacked
  ones, remat == no remat bit for bit, and the prefill / decode step
  builders == the model's functions;
- ``DataPipeline``: batches bit-equal for 5 steps; with ``conftest.py``'s
  ``dial_model`` converted, decisions equal to the reference's on its
  numpy sim (which ticks its workloads object by object) and per-host
  done bytes within 1e-6 relative, a forced straggler re-striped in
  both packages;
- checkpoints written by the port restored by the reference's manager
  and the other way round, exactly, ``keep`` honoured; ``train`` 6
  steps == 3 + resume 3 bit for bit; ``pfs_write``'s flush time within
  1e-9 relative.

The card's checks (the wrappers refusing gradients on CUDA tensors,
card == CPU gradients) are in ``test_torch_cuda.py``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.ckpt.manager import CheckpointManager as RefCkpt  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.data.pipeline import DataPipeline as RefPipeline  # noqa: E402
from repro.data.pipeline import PipelineConfig as RefPipelineConfig  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.pfs import PFSSim as RefSim  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, model_from_numpy,
                                 opt_state_from_numpy)
from repro_torch.data.pipeline import DataPipeline, PipelineConfig  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_cuda  # noqa: E402
from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda  # noqa: E402
from repro_torch.kernels.rglru_scan.kernel import rglru_cuda  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.pfs.engine import PFSSim  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.steps import (make_decode_step,  # noqa: E402
                                     make_prefill_step, make_train_step)

FAMILIES = ("gemma2-2b", "recurrentgemma-9b", "falcon-mamba-7b")
B, S = 2, 40          # 40 > the smoke window of 16; two loss chunks of 32
FOREST_FIELDS = ("feature", "threshold", "leaf", "base_score", "depth",
                 "n_features")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small shapes run fastest on one thread; more intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype="float32"):
    return (dataclasses.replace(ref_smoke(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


def ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, ref_lm.init_params(
        rcfg, jax.random.PRNGKey(seed)))


def tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def as_np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close_to_max(got, want, tol, what=""):
    """Within ``tol`` of the largest |want|."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bar, (what, err, bar)


def port_tree(cfg, ref_tree):
    """A reference-layout tree (numpy or jax leaves) in the port's layout,
    float32 tensors on the CPU."""
    return lm_params_from_numpy(cfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), ref_tree), "cpu")


def leaves_close(cfg, got, ref_tree, tol, what):
    want = port_tree(cfg, ref_tree)
    g, w = opt.tree_leaves(got), opt.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        close_to_max(a, b, tol, f"{what} leaf {i}")


# ---------------------------------------------------------------------- #
# the kernels refuse gradients
# ---------------------------------------------------------------------- #
def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """The LM kernels write through raw pointers: a gradient-requiring
    input raises before any device check, and passes under no_grad (to
    the device check, here on the CPU)."""
    f32 = lambda *s: torch.zeros(s, requires_grad=True)  # noqa: E731
    q, k = f32(1, 2, 4, 16), f32(1, 1, 4, 16)
    calls = {"flash_attention_cuda": lambda: flash_attention_cuda(q, k, k),
             "rglru_cuda": lambda: rglru_cuda(f32(1, 4, 8), f32(1, 4, 8)),
             "selective_scan_cuda": lambda: selective_scan_cuda(
                 f32(1, 4, 8), f32(1, 4, 8), f32(8, 4), f32(1, 4, 4),
                 f32(1, 4, 4), f32(8))}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}.*gradient"):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------- #
# the training forms: values and gradients
# ---------------------------------------------------------------------- #
def _torch_vjp(fn, inputs: dict, proj):
    ins = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    out = fn(**ins)
    (out * torch.tensor(proj)).sum().backward()
    return out, {k: t.grad for k, t in ins.items()}


def _jax_vjp(fn, inputs: dict, proj):
    @jax.jit
    def run(d, pr):
        out, vjp = jax.vjp(lambda d: fn(**d), d)
        return out, vjp(pr)[0]
    return run({k: jnp.asarray(v) for k, v in inputs.items()},
               jnp.asarray(proj))


@pytest.mark.parametrize("sq,skv,hq,hkv,window,softcap", [
    (40, 40, 4, 2, 0, 0.0), (40, 40, 4, 1, 16, 50.0), (24, 40, 2, 2, 0, 0.0),
    (40, 40, 4, 4, 7, 30.0)])
def test_chunked_attention_values_and_grads(sq, skv, hq, hkv, window,
                                            softcap):
    """Chunks of 16 (ragged last chunks, end-aligned queries, rows whose
    first key chunk is fully masked by the window): values and the
    q/k/v gradients within 1e-5 of the largest |value|."""
    rng = np.random.default_rng(sq + skv + window)
    x = {"q": rng.normal(size=(B, sq, hq, 16)).astype(np.float32),
         "k": rng.normal(size=(B, skv, hkv, 16)).astype(np.float32),
         "v": rng.normal(size=(B, skv, hkv, 16)).astype(np.float32)}
    proj = rng.normal(size=(B, sq, hq, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap, q_chunk=16,
              kv_chunk=16)
    out, grads = _torch_vjp(lambda **d: attn.chunked_attention(**d, **kw),
                            x, proj)
    r_out, r_grads = _jax_vjp(
        lambda **d: ref_attn.chunked_attention(**d, **kw), x, proj)
    close_to_max(out, r_out, 1e-5, "out")
    for k in x:
        close_to_max(grads[k], r_grads[k], 1e-5, f"d{k}")


def _block_case(arch, seed):
    rcfg, tcfg = configs(arch)
    rp = ref_params(rcfg, seed)
    layer = {"gemma2-2b": ("stack", 0, "attn"),
             "recurrentgemma-9b": ("stack", 0, "rec"),
             "falcon-mamba-7b": ("stack", 0, "mamba")}[arch]
    p = jax.tree.map(lambda a: a[0], rp[layer[0]][layer[1]][layer[2]])
    return rcfg, tcfg, {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_blocks_values_and_grads(arch):
    """``attention_block`` (global and local), ``recurrent_block`` (the
    associative scan) and ``mamba_block`` (the sequential scan):
    outputs and the gradients of x and every parameter within 1e-5 of
    the largest |value|."""
    rcfg, tcfg, p = _block_case(arch, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    proj = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    inputs = dict(x=x, **p)
    if arch == "gemma2-2b":
        cases = [(lambda x, **q: attn.attention_block(
            x, q, tcfg, torch.tensor(pos), window=w),
            lambda x, **q: ref_attn.attention_block(
                x, q, rcfg, jnp.asarray(pos, jnp.int32), window=w))
            for w in (0, tcfg.window_size)]
    elif arch == "recurrentgemma-9b":
        cases = [(lambda x, **q: rglru.recurrent_block(x, q, tcfg),
                  lambda x, **q: ref_rglru.recurrent_block(x, q, rcfg))]
    else:
        cases = [(lambda x, **q: mamba.mamba_block(x, q, tcfg),
                  lambda x, **q: ref_mamba.mamba_block(x, q, rcfg))]
    for mine, ref in cases:
        out, grads = _torch_vjp(mine, inputs, proj)
        r_out, r_grads = _jax_vjp(ref, inputs, proj)
        close_to_max(out, r_out, 1e-5, "out")
        for k in inputs:
            close_to_max(grads[k], r_grads[k], 1e-5, f"d{k}")


def test_rglru_assoc_scan_matches_the_sequential_recurrence():
    """The log-depth scan equals the plain S-step loop (the kernel's plain
    version) within 1e-5, at lengths off a power of two."""
    from repro_torch.kernels.rglru_scan.ref import rglru_ref
    rng = np.random.default_rng(3)
    for s in (1, 5, 33):
        x = torch.tensor(rng.normal(size=(2, s, 8)), dtype=torch.float32)
        a = torch.tensor(rng.uniform(0, 1, (2, s, 8)), dtype=torch.float32)
        close_to_max(rglru.rglru_assoc_scan(x, a), rglru_ref(x, a), 1e-5)


# ---------------------------------------------------------------------- #
# loss and train step
# ---------------------------------------------------------------------- #
def _batch_np(tcfg, seed=0, b=B, s=S):
    t = tokens(tcfg, seed, b, s)
    return {"tokens": t, "labels": t}


def _tbatch(nb):
    return {k: torch.tensor(v, dtype=torch.int64) for k, v in nb.items()}


def _jbatch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_fn_and_every_gradient(arch):
    """Two sequence chunks of 32 (the second padded with -1 labels): the
    loss within 1e-5 relative, each gradient leaf within 1e-5 of its
    largest |value|."""
    rcfg, tcfg = configs(arch)
    rp = ref_params(rcfg)
    nb = _batch_np(tcfg)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    leaves = opt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.loss_fn(params, _tbatch(nb), tcfg, seq_chunk=32)
    grads = torch.autograd.grad(loss, leaves)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, _jbatch(nb), rcfg, seq_chunk=32)))(rp)
    assert float(loss.detach()) == pytest.approx(float(r_loss), rel=1e-5)
    want = opt.tree_leaves(port_tree(tcfg, r_grads))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        close_to_max(g, w, 1e-5, f"leaf {i}")


def test_loss_fn_bf16():
    """bf16 smoke gemma2: the loss within 2e-2 (the packages round bf16
    products at other places)."""
    rcfg, tcfg = configs("gemma2-2b", "bfloat16")
    rp = jax.tree.map(np.asarray, ref_lm.init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
    nb = _batch_np(tcfg)
    loss = lm.loss_fn(lm_params_from_numpy(tcfg, rp, "cpu"), _tbatch(nb),
                      tcfg)
    r_loss = ref_lm.loss_fn(rp, _jbatch(nb), rcfg)
    assert abs(float(loss) - float(r_loss)) < 2e-2


def test_remat_equals_no_remat_bit_for_bit():
    """Checkpointed super-blocks and loss chunks recompute the same
    arithmetic: loss and every gradient bit-equal (recurrentgemma: a
    stack and a tail)."""
    _, tcfg = configs("recurrentgemma-9b")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = _tbatch(_batch_np(tcfg))
    leaves = opt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for remat in (True, False):
        loss = lm.loss_fn(params, batch, tcfg, seq_chunk=16, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def _opt_cfg(eps=1e-3):
    """Warmup 1, so all three steps are past it and decay, clipping and
    the cosine all act.  ``eps`` 1e-3 bounds Adam's gain on a gradient's
    last-bit rounding at 1/eps: at the default 1e-8 an element whose
    gradient is at rounding level (|g| ~ 1e-9) steps by about +-lr on
    its sign, whichever package computed it (up to 0.7% of a leaf's
    largest |value| after 3 steps here); the update's arithmetic at the
    default eps is held on equal gradients in
    ``test_adamw_update_on_equal_gradients``."""
    return ref_opt.AdamWConfig(peak_lr=1e-2, min_lr=1e-3, warmup_steps=1,
                               total_steps=4, clip_norm=0.5, eps=eps)


@pytest.mark.parametrize("arch,grad_accum", [
    ("gemma2-2b", 1), ("recurrentgemma-9b", 1), ("falcon-mamba-7b", 1),
    ("recurrentgemma-9b", 2), ("gemma2-2b", 2)])
def test_train_step_matches_reference(arch, grad_accum):
    """3 AdamW steps: loss, grad norm and lr within 1e-5 relative each
    step; every parameter and moment within 1e-5 of its leaf's largest
    |value| after the last."""
    rcfg, tcfg = configs(arch)
    rp = ref_params(rcfg)
    ocfg = _opt_cfg()
    tcfg_opt = opt.AdamWConfig(**dataclasses.asdict(ocfg))
    ref_step = jax.jit(ref_make_train_step(rcfg, ocfg, grad_accum))
    step = make_train_step(tcfg, tcfg_opt, grad_accum)
    r_state = (jax.tree.map(jnp.asarray, rp), ref_opt.init_opt_state(rp))
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    state = (params, opt.init_opt_state(params))
    for i in range(3):
        nb = _batch_np(tcfg, seed=10 + i, b=4)
        *r_state, r_m = ref_step(*r_state, _jbatch(nb))
        *state, m = step(*state, _tbatch(nb))
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(r_m[k]), rel=1e-5), (
                i, k)
    leaves_close(tcfg, state[0], r_state[0], 1e-5, "params")
    for k in ("m", "v"):
        leaves_close(tcfg, state[1][k], r_state[1][k], 1e-5, k)
    assert int(state[1]["step"]) == int(r_state[1]["step"]) == 3


@pytest.mark.parametrize("arch", FAMILIES)
def test_adamw_update_on_equal_gradients(arch):
    """Three updates at the default eps on the same (seeded) gradients:
    parameters, moments, grad norm and lr within 1e-6 of the reference's
    (relative; parameters of the leaf's largest |value|)."""
    rcfg, tcfg = configs(arch)
    rp = ref_params(rcfg)
    ocfg = dataclasses.replace(_opt_cfg(), eps=1e-8)
    rng = np.random.default_rng(5)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    state = opt.init_opt_state(params)
    r_p, r_s = rp, ref_opt.init_opt_state(rp)
    mask = opt.decay_mask(tcfg, params)
    ref_update = jax.jit(ref_opt.adamw_update, static_argnums=3)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape)
                                    * 10.0 ** rng.uniform(-9, 0))
                         .astype(np.float32), rp)
        r_p, r_s, r_m = ref_update(r_p, g, r_s, ocfg)
        params, state, m = opt.adamw_update(
            params, opt.tree_leaves(port_tree(tcfg, g)), state,
            opt.AdamWConfig(**dataclasses.asdict(ocfg)), mask)
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(r_m[k]), rel=1e-6)
    leaves_close(tcfg, params, r_p, 1e-6, "params")
    for k in ("m", "v"):
        leaves_close(tcfg, state[k], r_s[k], 1e-6, k)


def test_prefill_and_decode_steps_wrap_the_model():
    """``make_prefill_step`` / ``make_decode_step`` give ``lm.prefill`` /
    ``lm.decode_step``'s logits and caches bit for bit."""
    _, tcfg = configs("recurrentgemma-9b")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(2), "cpu")
    tok = torch.tensor(tokens(tcfg, b=2, s=12), dtype=torch.int64)
    logits, cache = make_prefill_step(tcfg, 16)(params, tok)
    want, want_cache = lm.prefill(params, tok, tcfg, 16)
    assert torch.equal(logits, want)
    nxt = logits.argmax(-1)
    got = make_decode_step(tcfg)(params, nxt, cache, 12)
    ref = lm.decode_step(params, nxt, want_cache, 12, tcfg)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(opt.tree_leaves(got[1]), opt.tree_leaves(ref[1])):
        assert torch.equal(a, b)


def test_decay_rule_on_stacked_and_tail_leaves():
    """recurrentgemma SMOKE (2 x 3 stacked layers + 2 tail layers): the
    reference decays its stacked layers' norm scales and gate vectors
    (rank 2 with the n_rep axis) and not the tail's; one update with zero
    gradients moves exactly the decayed leaves, in both packages alike."""
    rcfg, tcfg = configs("recurrentgemma-9b")
    rp = ref_params(rcfg)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    for layer in params["layers"]:         # non-zero vectors to decay
        for p in opt.tree_leaves(layer):
            if p.dim() == 1:
                p.fill_(0.5)
    rp = lm_params_to_numpy(tcfg, params)
    mask = opt.decay_mask(tcfg, params)
    names = [(j, k) for j, layer in enumerate(params["layers"])
             for k in sorted(layer) for _ in opt.tree_leaves(layer[k])]
    layer_of = dict(zip(map(id, opt.tree_leaves({"layers": params[
        "layers"]})), names))
    by_leaf = {layer_of.get(id(p)): d for p, d in zip(
        opt.tree_leaves(params), mask)}
    assert by_leaf[(0, "norm1")] and by_leaf[(5, "norm2")]
    assert not by_leaf[(6, "norm1")] and not by_leaf[(7, "norm2")]
    ocfg = ref_opt.AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=2)
    zero = jax.tree.map(np.zeros_like, rp)
    r_new, _, _ = ref_opt.adamw_update(rp, zero, ref_opt.init_opt_state(rp),
                                       ocfg)
    before = [p.clone() for p in opt.tree_leaves(params)]
    opt.adamw_update(params, [torch.zeros_like(p) for p in before],
                     opt.init_opt_state(params),
                     opt.AdamWConfig(**dataclasses.asdict(ocfg)), mask)
    for p, b, d in zip(opt.tree_leaves(params), before, mask):
        assert (not torch.equal(p, b)) == d
    leaves_close(tcfg, params, r_new, 1e-6, "params")


# ---------------------------------------------------------------------- #
# the data pipeline
# ---------------------------------------------------------------------- #
def _port_model(ref_model):
    fields = lambda f: {k: getattr(f, k) for k in FOREST_FIELDS}  # noqa: E731
    return model_from_numpy(fields(ref_model.read_forest),
                            fields(ref_model.write_forest), device="cpu")


def _decisions(agents):
    return [[(osc, op, tuple(int(t) for t in d.theta), bool(d.changed))
             for osc, op, d in a.decisions] for a in agents]


def _pipelines(dial_model, cfg_kw, setup=None):
    ref = RefPipeline(RefPipelineConfig(**cfg_kw), dial_model=dial_model)
    port = DataPipeline(PipelineConfig(**cfg_kw), device="cpu",
                        dial_model=(None if dial_model is None
                                    else _port_model(dial_model)))
    if setup is not None:
        setup(ref, port)
    return ref, port


def test_pipeline_batches_bit_equal():
    ref, port = _pipelines(None, dict(global_batch=4, seq_len=64,
                                      vocab_size=256, seed=7))
    for _ in range(5):
        a, b = ref.next_batch(), port.next_batch()
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state_dict() == ref.state_dict() == {"step_index": 5}


def _done_close(ref, port):
    want = [w.done_bytes(ref.sim) for w in ref.workloads]
    got = [w.done_bytes(port.sim) for w in port.workloads]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert port.ingest_throughput() == pytest.approx(
        ref.ingest_throughput(), rel=1e-6)


def test_pipeline_dial_decisions_equal_reference(dial_model):
    """``test_dial_improves_training_ingest``'s setup (two hosts, bad
    initial knobs) for 6 steps: every agent's decisions equal the
    reference's, per-host done bytes within 1e-6."""
    def bad_knobs(ref, port):
        for pipe in (ref, port):
            for h in range(2):
                pipe.sim.set_knobs(pipe.sim.client_oscs(h), window_pages=16,
                                   rpcs_in_flight=1)

    ref, port = _pipelines(dial_model, dict(
        global_batch=64, seq_len=2048, vocab_size=1000, n_hosts=2, seed=1),
        bad_knobs)
    for _ in range(6):
        ref.next_batch()
        port.next_batch()
    assert _decisions(port.agents) == _decisions(ref.agents)
    assert sum(len(a.decisions) for a in port.agents) > 0
    _done_close(ref, port)


def test_pipeline_straggler_restripe(dial_model):
    """Host 0 at 1 page x 1 in flight among four fast hosts: both
    packages re-stripe host 0 onto all OSTs, with equal decisions and
    done bytes.  A fast host delivers 520 MB a probe interval; at 530 MB
    a host a step the fast hosts still lag 10 MB after one interval (the
    median >= 0) while host 0 lags ~529 MB, past 3x the median."""
    def slow_host(ref, port):
        for pipe in (ref, port):
            pipe.sim.set_knobs(pipe.sim.client_oscs(0), window_pages=1,
                               rpcs_in_flight=1)

    ref, port = _pipelines(dial_model, dict(
        global_batch=4, seq_len=64, vocab_size=256, n_hosts=4, seed=2,
        bytes_per_token=530e6 * 4 / (4 * 64)), slow_host)
    for _ in range(2):
        ref.next_batch()
        port.next_batch()
    every = tuple(range(8))
    assert ref.workloads[0].osts == port.workloads[0].osts == every
    assert all(w.osts != every for w in port.workloads[1:])
    assert _decisions(port.agents) == _decisions(ref.agents)
    _done_close(ref, port)


# ---------------------------------------------------------------------- #
# checkpoints, resume, the PFS write path
# ---------------------------------------------------------------------- #
def test_checkpoint_restores_across_packages(tmp_path):
    """The port's checkpoint restored by the reference's manager, and the
    reference's by the port's, exactly (bf16 stored as float32), with
    the cursor in the metadata."""
    rcfg, tcfg = configs("recurrentgemma-9b", "bfloat16")
    rp = jax.tree.map(np.asarray, ref_lm.init_params(rcfg,
                                                     jax.random.PRNGKey(4)))
    r_opt = jax.tree.map(np.asarray, ref_opt.init_opt_state(rp))
    r_opt["m"] = jax.tree.map(lambda a: np.full(a.shape, 0.25, np.float32),
                              r_opt["m"])
    r_opt["step"] = np.asarray(7, np.int32)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    state = opt_state_from_numpy(tcfg, r_opt, "cpu")
    extra = {"pipeline": {"step_index": 7}}

    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(port_dir, cfg=tcfg).save(7, params, state, extra=extra)
    got_p, got_o, meta = RefCkpt(port_dir).restore(7, rp, r_opt)
    assert meta["extra"] == extra
    for a, b in zip(jax.tree.leaves((got_p, got_o)),
                    jax.tree.leaves((rp, r_opt))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))

    RefCkpt(ref_dir).save(7, rp, r_opt, extra=extra)
    mgr = CheckpointManager(ref_dir, cfg=tcfg)
    step, p2, o2, meta = mgr.restore_latest(params,
                                            opt.init_opt_state(params))
    assert step == 7 and meta["extra"] == extra
    for a, b in zip(opt.tree_leaves((p2, o2)),
                    opt.tree_leaves((params, state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(os.path.join(ref_dir, "ckpt_00000007.npz")) as z, \
            np.load(os.path.join(port_dir, "ckpt_00000007.npz")) as y:
        assert sorted(z.files) == sorted(y.files)


def test_checkpoint_keeps_the_latest(tmp_path):
    """``keep`` bounds the files (the oldest go, with their metadata); no
    temporary file stays visible; ``latest_step`` is the newest."""
    _, tcfg = configs("falcon-mamba-7b")
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, cfg=tcfg)
    assert mgr.latest_step() is None and mgr.restore_latest(params) is None
    for step in (1, 2, 5):
        mgr.save(step, params, extra={"pipeline": {"step_index": step}})
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000002.npz", "ckpt_00000002.npz.meta", "ckpt_00000005.npz",
        "ckpt_00000005.npz.meta"]
    step, p2, opt_state, meta = mgr.restore_latest(params)
    assert step == 5 and opt_state == {} and meta["step"] == 5
    assert all(torch.equal(a, b) for a, b in zip(
        opt.tree_leaves(p2), opt.tree_leaves(params)))


def test_train_resume_is_bit_exact(tmp_path, dial_model):
    """``train`` 6 steps == 3 steps with a checkpoint at 3, then the 6-step
    run resumed from it: steps 3-5's losses and the final parameters bit
    for bit (the pipeline's sim starts afresh; the tokens follow the
    cursor, the lr the step count, all three first steps in warmup)."""
    d = str(tmp_path / "ckpt")
    # a save through the PFS runs pfs_write's 200,000-tick guard in both
    # packages (ROADMAP Queue 3, reference fault 6); the accounting is
    # held in test_pfs_write_flush_time_matches_reference
    kw = dict(batch=4, seq_len=32, seed=3, log_every=100, device="cpu",
              dial_model=_port_model(dial_model), ckpt_through_pfs=False)
    full = train("recurrentgemma-9b", steps=6, **kw)
    train("recurrentgemma-9b", steps=3, ckpt_dir=d, ckpt_every=3, **kw)
    resumed = train("recurrentgemma-9b", steps=6, ckpt_dir=d, ckpt_every=3,
                    **kw)
    assert resumed["losses"] == full["losses"][3:]
    assert resumed["pipeline"].step_index == 6
    for a, b in zip(opt.tree_leaves(resumed["params"]),
                    opt.tree_leaves(full["params"])):
        assert torch.equal(a, b)


def test_pfs_write_flush_time_matches_reference(tmp_path):
    """``tests/test_system.py``'s accounting setup (2 clients x 4 OSTs,
    hosts 0 and 1, 256 MiB): the flush time within 1e-9 relative, and the
    write counters alike."""
    ref_sim = RefSim(n_clients=2, n_osts=4, seed=0)
    want = RefCkpt(str(tmp_path / "r"), sim=ref_sim,
                   hosts=[0, 1]).pfs_write(256 * 2**20)
    sim = PFSSim(2, 4, device="cpu")
    got = CheckpointManager(str(tmp_path / "p"), sim=sim,
                            hosts=[0, 1]).pfs_write(256 * 2**20)
    assert 0.05 < got < 60.0
    assert got == pytest.approx(want, rel=1e-9)
    for f in ("ctr_bytes_done", "ctr_req_count", "dirty_bytes",
              "ctr_rpcs_done"):
        np.testing.assert_allclose(getattr(sim, f).numpy(),
                                   getattr(ref_sim, f), rtol=1e-9)
