"""The seven families the port serves beside gemma2, recurrentgemma and
falcon-mamba, against the reference, at smoke size on the CPU.

olmoe-1b-7b and qwen2-moe-a2.7b (MoE layers), musicgen-large (four
codebooks: tokens (B, S, 4), logits (B, S, 4, V)), stablelm-12b,
starcoder2-15b and qwen1.5-32b (dense GQA / MHA, LayerNorm, GELU, q/k/v
biases) and llava-next-34b (an image prefix of ``img_tokens`` embeddings
before the text).  The same weights (the reference's ``init_params``,
converted) and the same inputs (as the reference's ``serve`` draws them,
seed 0) go through both packages, with ``test_torch_lm.py``'s bars:

- per family, float32 and bf16: ``prefill`` logits and caches (the
  image positions first), several ``decode_step``s fed the reference's
  tokens, ``generate``'s greedy tokens against the reference's serving
  loop (``repro/launch/serve.py:21-59``, which the reference's ``serve``
  itself runs on its own smoke config);
- the port's own prefill against token-by-token decode, for the
  families the reference holds so (``tests/test_models.py:58-61``);
- ``loss_fn`` and every gradient leaf in float32 (codebook labels, image
  positions without loss) against ``jax.value_and_grad`` of the
  reference's (1e-5); the MoE families' in ``test_torch_moe.py``;
- every config (the ten ``CONFIG`` and ``SMOKE``, ``demo-100m``,
  ``shapes``) field for field, the parameter counts in the reference's
  ranges (``tests/test_models.py:80-85``);
- a musicgen checkpoint across packages, exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.ckpt.manager import CheckpointManager as RefCkpt  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_cache_from_numpy,  # noqa: E402
                                 lm_params_from_numpy, opt_state_from_numpy)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.serve import generate, serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

NEW = ("olmoe-1b-7b", "qwen2-moe-a2.7b", "musicgen-large", "stablelm-12b",
       "starcoder2-15b", "qwen1.5-32b", "llava-next-34b")
B, S, GEN = 2, 32, 8
# the most tokens of one MoE layer (of B * S) that a bf16 near-tie may
# route otherwise than the reference does
MAX_FLIPS = 2
TOL = {"float32": dict(logits=2e-5, atol=2e-5, rtol=1e-4),
       "bfloat16": dict(logits=0.15, atol=0.05, rtol=0.02)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype):
    return (dataclasses.replace(ref_smoke(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


def close(got, want, atol, rtol=0.0, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def inputs(cfg, key, b=B, s=S):
    """The prompts (and a VLM's bf16 image embeddings) as the reference's
    ``serve`` draws them."""
    tshape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    prompts = jax.random.randint(key, tshape, 0, cfg.vocab_size)
    img = None
    if cfg.family == "vlm":
        img = jax.random.normal(key, (b, cfg.img_tokens, cfg.d_model),
                                jnp.bfloat16)
    return prompts, img


def reference_loop(params, prompts, img, cfg, gen_tokens):
    """``repro/launch/serve.py:21-59`` on given weights and inputs."""
    n_img = 0 if img is None else img.shape[1]
    max_len = prompts.shape[1] + gen_tokens + n_img
    prefill_fn = jax.jit(lambda p, t, i: ref_lm.prefill(
        p, t, cfg, max_len, img_embeds=i))
    decode_fn = jax.jit(lambda p, t, c, i: ref_lm.decode_step(p, t, c, i,
                                                              cfg))
    logits, cache = prefill_fn(params, prompts, img)
    out = {"prefill_logits": np.asarray(logits),
           "prefill_cache": jax.tree.map(np.asarray, cache), "steps": [],
           "max_len": max_len, "cur": prompts.shape[1] + n_img}
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for i in range(gen_tokens - 1):
        logits, cache = decode_fn(params, tok, cache,
                                  jnp.int32(out["cur"] + i))
        out["steps"].append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    out["tokens"] = np.concatenate(toks, axis=1)
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


def _torch(a):
    return None if a is None else torch.tensor(np.asarray(a, np.float32))


FAMILIES = [(a, d) for a in NEW for d in ("float32", "bfloat16")]


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda p: "-".join(p))
def family(request):
    arch, dtype = request.param
    rcfg, tcfg = configs(arch, dtype)
    key = jax.random.PRNGKey(0)
    rparams = ref_lm.init_params(rcfg, key)
    prompts, img = inputs(rcfg, key)
    ref = reference_loop(rparams, prompts, img, rcfg, GEN)
    params = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, rparams),
                                  "cpu")
    timg = _torch(img)
    if timg is not None:
        timg = timg.to(lm.dtype_of(tcfg))
    f = dict(arch=arch, dtype=dtype, rcfg=rcfg, tcfg=tcfg, params=params,
             prompts=torch.tensor(np.asarray(prompts)).long(), img=timg,
             ref=ref, tol=TOL[dtype])
    if rcfg.n_experts:
        f["routing"] = prefill_routing(f, rparams, prompts)
    return f


def _jnp_tree(p):
    """A port layer's parameters as the reference's arrays, bit for bit
    (bf16 stays bf16, the float32 router float32)."""
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(
        v.float().numpy(), jnp.bfloat16 if v.dtype == torch.bfloat16
        else jnp.float32) for k, v in p.items()}


def prefill_routing(f, rparams, prompts):
    """Each MoE layer's input in both packages' prefill (the reference's
    through a ``jax.debug.callback`` in its ``moe_mlp``), the top-k
    experts the reference's router picks on each package's input, and
    the port's layer (its own routing, output and aux) beside the
    reference's ``moe_mlp`` on the port's input."""
    got, want = [], []
    ref_fn, port_fn = ref_moe.moe_mlp, moe.moe_mlp

    def ref_spy(x, *a, **k):
        jax.debug.callback(lambda v: want.append(np.asarray(v, np.float32)),
                           x)
        return ref_fn(x, *a, **k)

    def port_spy(x, *a, **k):
        got.append(x.float().numpy())
        return port_fn(x, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_moe, "moe_mlp", ref_spy)
        mp.setattr(moe, "moe_mlp", port_spy)
        jax.block_until_ready(ref_lm.prefill(
            rparams, prompts, f["rcfg"], f["ref"]["max_len"]))
        lm.prefill(f["params"], f["prompts"], f["tcfg"], f["ref"]["max_len"])
    cfg = f["tcfg"]
    assert len(got) == len(want) == cfg.n_layers
    t = B * S
    g = moe.n_groups(cfg, t)
    out = []
    dt = lm.dtype_of(cfg)
    cap = int(moe.CAPACITY_FACTOR * cfg.top_k * (t // g) / cfg.n_experts) + 1
    for layer, (x, rx) in enumerate(zip(got, want)):
        p = f["params"]["layers"][layer]["moe"]
        router = p["router"].numpy()
        probs = [jax.nn.softmax(jnp.asarray(v).reshape(g, t // g, -1)
                                @ router, axis=-1) for v in (x, rx)]
        idx = [np.asarray(jax.lax.top_k(p, cfg.top_k)[1]) for p in probs]
        xt = torch.tensor(x).to(dt)
        own = moe.route(xt.reshape(g, t // g, -1), p["router"], cfg.top_k,
                        cfg.n_experts, cap)["idx"].numpy()
        port_out, port_aux = moe.moe_mlp(xt, p, cfg)
        ref_out, ref_aux = ref_moe.moe_mlp(
            jnp.asarray(x, jnp.bfloat16 if dt == torch.bfloat16
                        else jnp.float32), _jnp_tree(p), f["rcfg"])
        out.append(dict(x=x, ref_x=rx, idx=idx[0], ref_idx=idx[1],
                        ref_probs=np.asarray(probs[1]), router=router,
                        own_idx=own, out=port_out, aux=float(port_aux),
                        ref_out=np.asarray(ref_out, np.float32),
                        ref_aux=float(ref_aux)))
    return out


def first_flip(routing, tol):
    """The first MoE layer whose experts differ between the packages'
    inputs, and per differing token, at the first choice that differs
    (the reference's expert e1, the port's e2): the reference's
    probabilities of both, the log gap ln p(e1) - ln p(e2), the shift
    |(x_ref - x_port) . (w_e1 - w_e2)| of that logit difference the two
    inputs make, and the most an input within the bar (atol + rtol
    |x_ref| per element) can make; None if no layer differs."""
    for layer, r in enumerate(routing):
        bad = np.argwhere((r["idx"] != r["ref_idx"]).any(-1))
        if len(bad):
            g, tl = r["idx"].shape[:2]
            x, rx = (v.reshape(g, tl, -1) for v in (r["x"], r["ref_x"]))
            gaps = []
            for gi, ti in bad:
                j = int(np.argmax(r["idx"][gi, ti] != r["ref_idx"][gi, ti]))
                e1, e2 = r["ref_idx"][gi, ti, j], r["idx"][gi, ti, j]
                p = r["ref_probs"][gi, ti]
                dw = r["router"][:, e1] - r["router"][:, e2]
                gaps.append(dict(
                    p_ref=float(p[e1]), p_port=float(p[e2]),
                    log_gap=float(np.log(p[e1]) - np.log(p[e2])),
                    shift=float(abs((rx[gi, ti] - x[gi, ti]) @ dw)),
                    bar=float((tol["atol"] + tol["rtol"]
                               * np.abs(rx[gi, ti])) @ np.abs(dw))))
            return layer, gaps
    return None


def check_cache(cache, ref_cache, cfg, tol, what, n_layers=None):
    want = (ref_cache if isinstance(ref_cache, list)
            else lm_cache_from_numpy(cfg, ref_cache, "cpu"))
    assert len(cache) == len(want) == (n_layers or cfg.n_layers)
    for i, (c, w) in enumerate(zip(cache, want)):
        assert c.keys() == w.keys(), (what, i)
        for name in c:
            assert c[name].dtype == w[name].dtype, (what, i, name)
            close(c[name], w[name].float().numpy(), tol["atol"], tol["rtol"],
                  f"{what}: layer {i} ({cfg.layer_types()[i]}) {name}")


def logits_shape(cfg, b=B):
    return (b, 1) + ((cfg.num_codebooks,) if cfg.num_codebooks else ()) \
        + (cfg.vocab_size,)


def test_prefill_matches_reference(family):
    """Logits (B, 1, [K,] V) and every layer's cache; a VLM's cache holds
    the image and the prompt, I + S positions, and nothing after.

    Every MoE layer of the port, on its own input, routes as the
    reference's ``moe_mlp`` on that same input (top-k identical), with
    the output within the bar and the aux within 1e-6.  Then each
    package's router on its own input: in bf16 the two inputs differ by
    rounding (within the bar), and a token whose reference probabilities
    of two experts are that close may take the other one; the capacity
    then drops other tokens, and everything after that layer parts.  A
    flip must be such a near-tie: at most MAX_FLIPS tokens, each log gap
    no more than the shift the two inputs make in that logit difference
    (so the inputs' difference alone explains it) and than the most an
    input within the bar can make.  Then the inputs and caches are held
    up to that layer and the gaps recorded (see the report's captured
    output); float32 must route identically."""
    f, tol, cfg = family, family["tol"], family["tcfg"]
    logits, cache = lm.prefill(f["params"], f["prompts"], cfg,
                               f["ref"]["max_len"], img_embeds=f["img"])
    assert logits.dtype == torch.float32
    assert logits.shape == logits_shape(cfg)
    for i, r in enumerate(f.get("routing", [])):
        np.testing.assert_array_equal(r["own_idx"], r["idx"], f"layer {i}")
        close(r["out"], r["ref_out"], tol["atol"], tol["rtol"],
              f"layer {i}'s MoE output on the port's input")
        assert abs(r["aux"] - r["ref_aux"]) <= 1e-6, (i, r["aux"],
                                                      r["ref_aux"])
    flip = first_flip(f["routing"], tol) if "routing" in f else None
    if flip is not None:
        layer, gaps = flip
        assert f["dtype"] == "bfloat16", (f["arch"], flip)
        print(f"{f['arch']} bf16 prefill: layer {layer} routes "
              f"{len(gaps)} token(s) otherwise: {gaps}")
        assert len(gaps) <= MAX_FLIPS, (f["arch"], layer, gaps)
        for gp in gaps:
            assert 0.0 <= gp["log_gap"] <= gp["shift"] + 1e-4, gp
            assert gp["log_gap"] <= gp["bar"], gp
        for r in f["routing"][:layer + 1]:
            close(r["x"], r["ref_x"], tol["atol"], tol["rtol"], "MoE input")
        check_cache(cache[:layer + 1], [
            c for c in lm_cache_from_numpy(f["tcfg"],
                                           f["ref"]["prefill_cache"],
                                           "cpu")[:layer + 1]],
            cfg, tol, "prefill", n_layers=layer + 1)
    else:
        close(logits, f["ref"]["prefill_logits"], tol["logits"], 0.0,
              "logits")
        check_cache(cache, f["ref"]["prefill_cache"], cfg, tol, "prefill")
    cur = f["ref"]["cur"]
    assert cur == S + cfg.img_tokens
    k = cache[0]["k"]
    assert k.shape[2] == f["ref"]["max_len"]
    assert bool(k[:, :, cur - 1].any()) and not k[:, :, cur:].any()


def test_decode_steps_match_reference(family):
    """Decode from the reference's prefill cache at I + S + i, fed the
    reference's tokens (B, 1[, K])."""
    f, tol = family, family["tol"]
    cache = lm_cache_from_numpy(f["tcfg"], f["ref"]["prefill_cache"], "cpu")
    toks = f["ref"]["tokens"]
    for i, want in enumerate(f["ref"]["steps"]):
        logits, cache = lm.decode_step(
            f["params"], torch.tensor(toks[:, i:i + 1]).long(), cache,
            f["ref"]["cur"] + i, f["tcfg"])
        assert logits.shape == logits_shape(f["tcfg"])
        close(logits, want, tol["logits"], 0.0, f"decode step {i}")
    check_cache(cache, f["ref"]["cache"], f["tcfg"], tol, "after decode")


def test_generate_tokens_match_reference(family):
    """Greedy tokens (B, T[, K]): float32 identical; bf16 identical up to
    a sequence's first step where any of its reference's choices has a
    top-2 gap within twice the logits bar."""
    f = family
    n0 = sum(LAUNCHES.values())
    out = generate(f["params"], f["prompts"], f["tcfg"], GEN,
                   f["ref"]["max_len"], img_embeds=f["img"])
    assert sum(LAUNCHES.values()) == n0
    got, want = out["tokens"], f["ref"]["tokens"]
    assert got.shape == want.shape == (B, GEN) + want.shape[2:]
    if f["dtype"] == "float32":
        np.testing.assert_array_equal(got, want)
        return
    steps = [f["ref"]["prefill_logits"]] + f["ref"]["steps"]
    for b in range(B):
        for t, lg in enumerate(steps):
            top2 = np.sort(lg[b, 0], axis=-1)[..., -2:]
            if (top2[..., 1] - top2[..., 0] <= 2 * f["tol"]["logits"]).any():
                break
            np.testing.assert_array_equal(got[b, t], want[b, t],
                                          err_msg=f"{f['arch']} {b} {t}")


@pytest.mark.parametrize("arch", NEW)
def test_generate_reproduces_reference_serve(arch):
    """The reference loop above is ``serve``'s, on the reference's own
    smoke config (bf16, seed 0); and the port's ``serve`` on the CPU
    gives the reference's shapes."""
    rcfg, _ = configs(arch, "bfloat16")
    key = jax.random.PRNGKey(0)
    prompts, img = inputs(rcfg, key)
    want = ref_serve(arch, batch=B, prompt_len=S, gen_tokens=GEN,
                     smoke=True, seed=0)["tokens"]
    got = reference_loop(ref_lm.init_params(rcfg, key), prompts, img, rcfg,
                         GEN)["tokens"]
    np.testing.assert_array_equal(got, want)
    mine = serve(arch, batch=B, prompt_len=S, gen_tokens=GEN, device="cpu")
    assert mine["tokens"].shape == want.shape
    assert mine["logits"].shape == logits_shape(rcfg)


@pytest.mark.parametrize("arch", ["stablelm-12b", "musicgen-large"])
def test_prefill_decode_consistency(arch):
    """Token-by-token decode from an empty cache reproduces the prefill
    logits (the port's own paths; bf16 smoke config; 5e-2)."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, "cpu")
    shape = (B, S) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    plog, _ = lm.prefill(params, tokens, cfg, S + 8)
    cache = lm.init_cache(cfg, B, S + 8, "cpu")
    for t in range(S):
        dlog, cache = lm.decode_step(params, tokens[:, t:t + 1], cache, t, cfg)
    assert float((plog - dlog).abs().max()) < 5e-2


# ---------------------------------------------------------------------- #
# training forms
# ---------------------------------------------------------------------- #
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


@pytest.mark.parametrize("arch", ["musicgen-large", "stablelm-12b",
                                  "starcoder2-15b", "qwen1.5-32b",
                                  "llava-next-34b"])
def test_loss_fn_and_every_gradient(arch):
    """Two loss chunks of 32, the second padded on the sequence axis
    (codebook labels (B, S, 4) too); llava's image positions take no
    loss; the image embeddings float32 here.  The loss within 1e-5
    relative, each gradient leaf within 1e-5 of its largest |value|."""
    rcfg, tcfg = configs(arch, "float32")
    rp = jax.tree.map(np.asarray, ref_lm.init_params(
        rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    shape = (B, 40) + ((rcfg.num_codebooks,) if rcfg.num_codebooks else ())
    t = rng.integers(0, rcfg.vocab_size, shape).astype(np.int32)
    nb = {"tokens": t, "labels": t}
    if rcfg.img_tokens:
        nb["img_embeds"] = rng.normal(
            size=(B, rcfg.img_tokens, rcfg.d_model)).astype(np.float32)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    leaves = opt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.tensor(v) for k, v in nb.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    loss = lm.loss_fn(params, tb, tcfg, seq_chunk=32)
    grads = torch.autograd.grad(loss, leaves)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    r_loss, r_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, jb, rcfg, seq_chunk=32)))(rp)
    assert float(loss.detach()) == pytest.approx(float(r_loss), rel=1e-5)
    want = opt.tree_leaves(lm_params_from_numpy(tcfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), r_grads), "cpu"))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        close_to_max(g, w, 1e-5, f"leaf {i}")


def test_loss_pads_the_sequence_axis_of_codebook_labels():
    """musicgen: 39 shifted positions in chunks of 16 pad the labels'
    sequence axis with -1 (not the codebook axis): the loss equals the
    unchunked one and counts 39 x 4 labels a sequence."""
    cfg = dataclasses.replace(get_smoke_config("musicgen-large"),
                              param_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    t = torch.randint(0, cfg.vocab_size, (B, 40, 4),
                      generator=torch.Generator().manual_seed(4))
    batch = {"tokens": t, "labels": t}
    chunked = lm.loss_fn(params, batch, cfg, seq_chunk=16)
    whole = lm.loss_fn(params, batch, cfg, seq_chunk=39)
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)
    x, _ = lm.forward_train(params, t, cfg)
    _, n = lm._chunk_nll(params, x[:, :-1], t[:, 1:], cfg)
    assert int(n) == B * 39 * 4


# ---------------------------------------------------------------------- #
# configs and checkpoints
# ---------------------------------------------------------------------- #
def test_configs_equal_the_reference():
    """All ten CONFIG and SMOKE, demo-100m and the shape sets field for
    field; ``param_count`` equal and in the reference's ranges."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import all_configs as ref_all
    from repro.configs import demo_100m as ref_demo
    from repro.configs import shapes as ref_shapes
    from repro_torch.configs import ARCHS, all_configs, get_config
    from repro_torch.configs import demo_100m, shapes

    ranges = {"gemma2-2b": (2.0, 3.5), "stablelm-12b": (11, 14),
              "starcoder2-15b": (14, 17), "qwen1.5-32b": (30, 36),
              "falcon-mamba-7b": (6.5, 8.5), "olmoe-1b-7b": (6, 8),
              "recurrentgemma-9b": (8, 11), "llava-next-34b": (32, 36),
              "qwen2-moe-a2.7b": (13, 16), "musicgen-large": (2, 3.5)}
    assert ARCHS == REF_ARCHS
    mine, ref = all_configs(), ref_all()
    assert list(mine) == list(ref)
    asdict = dataclasses.asdict
    for arch in ARCHS:
        for a, b in ((mine[arch], ref[arch]),
                     (get_smoke_config(arch), ref_smoke(arch))):
            assert asdict(a) == asdict(b), arch
            assert a.param_count() == b.param_count()
            assert a.active_param_count() == b.active_param_count()
            assert a.layer_types() == b.layer_types()
        lo, hi = ranges[arch]
        assert lo * 1e9 <= get_config(arch).param_count() <= hi * 1e9
    for a, b in ((demo_100m.CONFIG, ref_demo.CONFIG),
                 (demo_100m.SMOKE, ref_demo.SMOKE)):
        assert asdict(a) == asdict(b)
    assert {k: asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: asdict(v) for k, v in ref_shapes.SHAPES.items()}
    assert shapes.LONG_CONTEXT_ARCHS == ref_shapes.LONG_CONTEXT_ARCHS
    for arch in ARCHS:
        assert shapes.applicable_shapes(arch) == \
            ref_shapes.applicable_shapes(arch)


def test_codebook_checkpoint_restores_across_packages(tmp_path):
    """musicgen-large SMOKE, bf16 (embedding (4, V, D), head (4, D, V)):
    the port's checkpoint restored by the reference's manager and the
    reference's by the port's, exactly."""
    rcfg, tcfg = ref_smoke("musicgen-large"), get_smoke_config(
        "musicgen-large")
    rp = jax.tree.map(np.asarray, ref_lm.init_params(rcfg,
                                                     jax.random.PRNGKey(5)))
    r_opt = jax.tree.map(np.asarray, ref_opt.init_opt_state(rp))
    r_opt["m"] = jax.tree.map(lambda a: np.full(a.shape, -0.125, np.float32),
                              r_opt["m"])
    r_opt["step"] = np.asarray(2, np.int32)
    params = lm_params_from_numpy(tcfg, rp, "cpu")
    state = opt_state_from_numpy(tcfg, r_opt, "cpu")
    assert params["embed"].shape == (4, tcfg.vocab_size, tcfg.d_model)
    assert params["head"].shape == (4, tcfg.d_model, tcfg.vocab_size)
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(port_dir, cfg=tcfg).save(2, params, state)
    got_p, got_o, _ = RefCkpt(port_dir).restore(2, rp, r_opt)
    for a, b in zip(jax.tree.leaves((got_p, got_o)),
                    jax.tree.leaves((rp, r_opt))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    RefCkpt(ref_dir).save(2, rp, r_opt)
    step, p2, o2, _ = CheckpointManager(ref_dir, cfg=tcfg).restore_latest(
        params, opt.init_opt_state(params))
    assert step == 2
    for a, b in zip(opt.tree_leaves((p2, o2)),
                    opt.tree_leaves((params, state))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_train_launcher_feeds_codebooks_and_zero_images(arch):
    """``train`` on a smoke config: the pipeline's codebook batches (B, S,
    4), a VLM's zero bf16 image embeddings (the reference's
    ``launch/train.py:85-92``); the first step's loss is ``loss_fn`` on
    the initial parameters and the pipeline's first batch, bit for bit."""
    from repro_torch.data.pipeline import DataPipeline, PipelineConfig
    from repro_torch.launch.train import train

    cfg = get_smoke_config(arch)
    kw = dict(global_batch=2, seq_len=16, n_hosts=2)
    out = train(arch, steps=2, batch=kw["global_batch"],
                seq_len=kw["seq_len"], n_hosts=kw["n_hosts"], device="cpu",
                dial_model_path=None, log_every=100)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    nb = DataPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, num_codebooks=cfg.num_codebooks, seed=0,
        **kw), device="cpu").next_batch()
    assert nb["tokens"].shape == (2, 16) + ((4,) if cfg.num_codebooks
                                            else ())
    batch = {k: torch.as_tensor(v).long() for k, v in nb.items()}
    if cfg.img_tokens:
        batch["img_embeds"] = torch.zeros(
            (2, cfg.img_tokens, cfg.d_model), dtype=torch.bfloat16)
    assert float(lm.loss_fn(params, batch, cfg)) == out["losses"][0]
