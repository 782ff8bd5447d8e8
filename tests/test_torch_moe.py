"""The port's MoE layer and its training path against the reference's, at
smoke size on the CPU.

The same parameters (the reference's ``init_moe`` / ``init_params``,
converted) and the same inputs (numpy, from a seed) go through both
packages, float32:

- ``moe_mlp`` at olmoe-1b-7b and qwen2-moe-a2.7b SMOKE and at a
  hand-made config (padded experts, three groups, a GELU expert MLP):
  the top-k experts, the keep mask and the ranks identical to the
  reference's routing (``repro/models/moe.py:59-77``, the same jnp
  statements on the same router logits), the output within 2e-5, the
  aux loss within 1e-6; a router built to overflow one expert keeps the
  same tokens; decode's groups of one token; Qwen2-MoE's shared experts
  behind a non-zero gate;
- ``loss_fn`` with the aux loss and every gradient leaf of both MoE
  smoke configs against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` (the loss within 1e-5 relative, each leaf within 1e-5 of
  its largest |value|), and 3 AdamW steps of olmoe-1b-7b SMOKE (loss,
  grad norm, lr, every parameter and moment, the reference's decay set);
- an MoE checkpoint written by either package restored by the other,
  exactly.

No routing decision here is a near-tie: the cases' top-k gaps are
printed by the assertion messages if one ever differs.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.ckpt.manager import CheckpointManager as RefCkpt  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 opt_state_from_numpy)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **kw):
    return (dataclasses.replace(ref_smoke(arch), param_dtype="float32", **kw),
            dataclasses.replace(get_smoke_config(arch),
                                param_dtype="float32", **kw))


HAND = dict(n_experts=5, top_k=3, n_experts_pad=8, moe_groups=3, d_expert=24,
            act="gelu", n_shared_experts=1)


def case_configs(name):
    if name == "hand":
        return configs("qwen2-moe-a2.7b", **HAND)
    return configs(name)


def as_np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close_to_max(got, want, tol, what=""):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= bar, (what, err, bar)


def ref_routing(x, p, cfg):
    """``repro/models/moe.py:59-77`` on x (B, S, D): idx, rank, keep over
    the flat (g, tl * k) axis."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = ref_moe._n_groups(cfg, t)
    tl = t // g
    xt = x.reshape(g, tl, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    cap = int(ref_moe.CAPACITY_FACTOR * k * tl / e) + 1
    flat_e = idx.reshape(g, tl * k)
    oh = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    rank = (jnp.cumsum(oh, axis=1) - oh)[
        jnp.arange(g)[:, None], jnp.arange(tl * k)[None, :], flat_e]
    return dict(idx=np.asarray(idx), rank=np.asarray(rank),
                keep=np.asarray(rank < cap), probs=np.asarray(probs), g=g)


def moe_params(rcfg, seed, shared_gate=True):
    """The reference's ``init_moe`` (numpy leaves); the shared experts'
    gate (zeros at init) drawn so that it matters."""
    p = jax.tree.map(np.array, ref_moe.init_moe(rcfg,
                                                jax.random.PRNGKey(seed)))
    if "shared_gate" in p and shared_gate:
        p["shared_gate"] = np.random.default_rng(seed).normal(
            size=p["shared_gate"].shape).astype(np.float32)
    return p


def run_both(x, p, rcfg, tcfg):
    """(port out, aux, routing), (reference out, aux, routing)."""
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), p)
    jp = jax.tree.map(jnp.asarray, p)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    out, aux = moe.moe_mlp(tx, tp, tcfg)
    r_out, r_aux = ref_moe.moe_mlp(jx, jp, rcfg)
    e, k = tcfg.n_experts, tcfg.top_k
    g = moe.n_groups(tcfg, x.shape[0] * x.shape[1])
    tl = x.shape[0] * x.shape[1] // g
    route = moe.route(tx.reshape(g, tl, -1), tp["router"], k, e,
                      int(moe.CAPACITY_FACTOR * k * tl / e) + 1)
    return (out, aux, route), (r_out, r_aux, ref_routing(jx, jp, rcfg))


def check_routing(route, ref, what):
    idx = route["idx"].numpy()
    if not np.array_equal(idx, ref["idx"]):
        bad = np.argwhere(idx != ref["idx"])[0]
        top = np.sort(ref["probs"][tuple(bad[:2])])[::-1]
        raise AssertionError(f"{what}: top-k differs at {bad}; the "
                             f"reference's probabilities {top[:4]}")
    np.testing.assert_array_equal(route["rank"].numpy(), ref["rank"])
    np.testing.assert_array_equal(route["keep"].numpy(), ref["keep"])


@pytest.mark.parametrize("name", MOE_ARCHS + ("hand",))
def test_moe_mlp_matches_reference(name):
    rcfg, tcfg = case_configs(name)
    p = moe_params(rcfg, 1)
    x = np.random.default_rng(2).normal(
        size=(B, S, rcfg.d_model)).astype(np.float32)
    (out, aux, route), (r_out, r_aux, ref) = run_both(x, p, rcfg, tcfg)
    assert ref["g"] == moe.n_groups(tcfg, B * S)
    check_routing(route, ref, name)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert np.abs(as_np(out) - as_np(r_out)).max() <= 2e-5
    assert abs(float(aux) - float(r_aux)) <= 1e-6


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_overflow_drops_the_same_tokens(name):
    """A constant input feature that the router weighs towards expert 0
    sends (nearly) every token there first: the expert overflows its
    capacity in every group, and both packages keep the group's earliest
    tokens and drop the rest.  The other probabilities stay apart (no
    tie)."""
    rcfg, tcfg = case_configs(name)
    p = moe_params(rcfg, 3)
    p["router"][0, 0] += 2.0
    x = np.random.default_rng(4).normal(
        size=(B, S, rcfg.d_model)).astype(np.float32)
    x[..., 0] = 3.0
    (out, aux, route), (r_out, r_aux, ref) = run_both(x, p, rcfg, tcfg)
    first = ref["idx"][..., 0]
    assert (first == 0).mean() > 0.9 and not ref["keep"].all()
    check_routing(route, ref, name)
    assert np.abs(as_np(out) - as_np(r_out)).max() <= 2e-5
    assert abs(float(aux) - float(r_aux)) <= 1e-6


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_decode_groups_of_one_token(name):
    """Decode at B = 4: 16 groups halve to 4, each of one token (capacity
    1, no drop); a qwen2-moe gate of zeros (its init) halves the shared
    experts."""
    rcfg, tcfg = case_configs(name)
    p = moe_params(rcfg, 5, shared_gate=False)
    x = np.random.default_rng(6).normal(
        size=(4, 1, rcfg.d_model)).astype(np.float32)
    (out, aux, route), (r_out, r_aux, ref) = run_both(x, p, rcfg, tcfg)
    assert ref["g"] == moe.n_groups(tcfg, 4) == 4 and ref["keep"].all()
    check_routing(route, ref, name)
    assert np.abs(as_np(out) - as_np(r_out)).max() <= 2e-5
    assert abs(float(aux) - float(r_aux)) <= 1e-6


def test_shared_expert_gate():
    """Qwen2-MoE's shared experts: ``sigmoid(x @ shared_gate)`` times
    their MLP, added to the routed output.  With the same router and
    experts, a gate of zeros (its init), a random one and a strongly
    negative one each give the reference's output; the last leaves the
    routed experts' output alone, the first two differ."""
    rcfg, tcfg = case_configs("qwen2-moe-a2.7b")
    x = np.abs(np.random.default_rng(7).normal(
        size=(B, S, rcfg.d_model))).astype(np.float32)
    gates = {"zeros": lambda a: np.zeros_like(a),
             "random": lambda a: a,
             "closed": lambda a: np.full_like(a, -50.0)}
    outs = {}
    for name, gate in gates.items():
        p = moe_params(rcfg, 8)
        p["shared_gate"] = gate(p["shared_gate"])
        (out, _, _), (r_out, _, _) = run_both(x, p, rcfg, tcfg)
        assert np.abs(as_np(out) - as_np(r_out)).max() <= 2e-5, name
        outs[name] = as_np(out)
    p = moe_params(rcfg, 8)
    del p["shared"], p["shared_gate"]
    routed, _ = moe.moe_mlp(torch.tensor(x), jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)), p), dataclasses.replace(
            tcfg, n_shared_experts=0))
    assert np.abs(outs["closed"] - as_np(routed)).max() <= 1e-5
    assert np.abs(outs["random"] - outs["zeros"]).max() > 1e-3


# ---------------------------------------------------------------------- #
# training
# ---------------------------------------------------------------------- #
def ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, ref_lm.init_params(
        rcfg, jax.random.PRNGKey(seed)))


def batch_np(cfg, seed=0, b=B, s=40):
    t = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": t, "labels": t}


def tbatch(nb):
    return {k: torch.tensor(v, dtype=torch.int64) for k, v in nb.items()}


def jbatch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def port_tree(cfg, ref_tree):
    return lm_params_from_numpy(cfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), ref_tree), "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_fn_and_every_gradient(arch):
    """Two loss chunks of 32 (the second padded), the aux loss's 0.01 in:
    the loss within 1e-5 relative, each gradient leaf (the float32
    router's, the experts', the shared MLP's and its gate's) within 1e-5
    of its largest |value|."""
    rcfg, tcfg = configs(arch)
    rp = ref_params(rcfg)
    nb = batch_np(tcfg)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    leaves = opt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = lm.loss_fn(params, tbatch(nb), tcfg, seq_chunk=32)
    grads = torch.autograd.grad(loss, leaves)
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, jbatch(nb), rcfg, seq_chunk=32)))(rp)
    assert float(loss.detach()) == pytest.approx(float(r_loss), rel=1e-5)
    # the aux loss is in: without it the loss moves by 0.01 x aux
    with torch.no_grad():
        _, aux = lm.forward_train(params, tbatch(nb)["tokens"], tcfg)
    assert float(aux) > 0.5 * tcfg.n_layers
    want = opt.tree_leaves(port_tree(tcfg, r_grads))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        close_to_max(g, w, 1e-5, f"leaf {i}")


def test_moe_train_step_matches_reference():
    """3 AdamW steps of olmoe-1b-7b SMOKE (Adam's eps 1e-3, as
    ``test_torch_train.py``): loss, grad norm and lr within 1e-5
    relative each step, every parameter and moment within 1e-5 of its
    leaf's largest |value| after the last; the decay set is the
    reference's (the stacked router, experts and norms decayed)."""
    rcfg, tcfg = configs("olmoe-1b-7b")
    rp = ref_params(rcfg)
    ocfg = ref_opt.AdamWConfig(peak_lr=1e-2, min_lr=1e-3, warmup_steps=1,
                               total_steps=4, clip_norm=0.5, eps=1e-3)
    ref_step = jax.jit(ref_make_train_step(rcfg, ocfg))
    step = make_train_step(tcfg, opt.AdamWConfig(**dataclasses.asdict(ocfg)))
    r_state = (jax.tree.map(jnp.asarray, rp), ref_opt.init_opt_state(rp))
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    mask = opt.decay_mask(tcfg, params)
    names = [k for k in sorted(params["layers"][0]["moe"])]
    layer0 = opt.tree_leaves(params["layers"][0]["moe"])
    by_id = dict(zip(map(id, opt.tree_leaves(params)), mask))
    assert all(by_id[id(p)] for p in layer0), names
    assert not by_id[id(params["final_norm"]["scale"])]
    state = (params, opt.init_opt_state(params))
    for i in range(3):
        nb = batch_np(tcfg, seed=10 + i, b=4)
        *r_state, r_m = ref_step(*r_state, jbatch(nb))
        *state, m = step(*state, tbatch(nb))
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(r_m[k]), rel=1e-5), (
                i, k)
    for got, want in ((state[0], r_state[0]), (state[1]["m"], r_state[1]["m"]),
                      (state[1]["v"], r_state[1]["v"])):
        g, w = opt.tree_leaves(got), opt.tree_leaves(port_tree(tcfg, want))
        assert len(g) == len(w)
        for j, (a, b) in enumerate(zip(g, w)):
            close_to_max(a, b, 1e-5, f"leaf {j}")


def test_moe_checkpoint_restores_across_packages(tmp_path):
    """qwen2-moe-a2.7b SMOKE in bf16 (the router float32, the nested
    shared MLP and its gate): the port's checkpoint restored by the
    reference's manager and the reference's by the port's, exactly."""
    rcfg = dataclasses.replace(ref_smoke("qwen2-moe-a2.7b"))
    tcfg = get_smoke_config("qwen2-moe-a2.7b")
    rp = ref_params(rcfg, 4)
    r_opt = jax.tree.map(np.asarray, ref_opt.init_opt_state(rp))
    r_opt["v"] = jax.tree.map(lambda a: np.full(a.shape, 0.5, np.float32),
                              r_opt["v"])
    r_opt["step"] = np.asarray(3, np.int32)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    state = opt_state_from_numpy(tcfg, r_opt, "cpu")
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    assert params["layers"][1]["moe"]["gate"].dtype == torch.bfloat16
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(port_dir, cfg=tcfg).save(3, params, state)
    got_p, got_o, _ = RefCkpt(port_dir).restore(3, rp, r_opt)
    for a, b in zip(jax.tree.leaves((got_p, got_o)),
                    jax.tree.leaves((rp, r_opt))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    RefCkpt(ref_dir).save(3, rp, r_opt)
    step, p2, o2, _ = CheckpointManager(ref_dir, cfg=tcfg).restore_latest(
        params, opt.init_opt_state(params))
    assert step == 3
    for a, b in zip(opt.tree_leaves((p2, o2)),
                    opt.tree_leaves((params, state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
