"""The port's LM serving path against the reference's, at smoke size.

The same weights (the reference's ``init_params``, converted) and the
same inputs (numpy, from a seed) go through both packages:

- each layer function against its JAX counterpart, float32, within
  2e-5 (the attention kernels' float32 bar; the scans' 1e-4 where an
  RG-LRU or selective scan sums in another order);
- per family (gemma2-2b, recurrentgemma-9b, falcon-mamba-7b SMOKE; the
  other seven in ``test_torch_lm_families.py``), in float32 and in bf16: ``prefill`` logits and caches, several
  ``decode_step``s fed the reference's tokens, and ``generate``'s
  greedy tokens against the reference's serving loop
  (``repro/launch/serve.py:37-59``, which ``serve`` itself runs).
  Float32: logits and states within 2e-5 absolute, 1e-4 relative;
  tokens identical.  bf16: logits within 0.15 (five bf16 steps at the
  logits' scale of ~4; the packages round bf16 products in other
  places), states within 0.05 + 0.02 relative; tokens identical up to
  the first step whose reference top-2 gap is within twice that logits
  bar (either package may pick either token there, and the sequences
  part);
- the port's own prefill against token-by-token decode from an empty
  cache (``tests/test_models.py:62``'s check, its 5e-2 bar).

The CUDA kernels' checks are in ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch.serve import serve as ref_serve  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_cache_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch.serve import generate, serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

B, S, GEN = 2, 32, 8          # the prompt is longer than the 16 window
# the families held here; test_torch_lm_families.py holds the other seven
SERVED = ("gemma2-2b", "recurrentgemma-9b", "falcon-mamba-7b")
TOL = {"float32": dict(logits=2e-5, atol=2e-5, rtol=1e-4),
       "bfloat16": dict(logits=0.15, atol=0.05, rtol=0.02)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small shapes run fastest on one thread; more intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, dtype):
    return (dataclasses.replace(ref_smoke(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


def to_torch(tree):
    """A reference parameter tree (float32 leaves) as torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def close(got, want, atol, rtol=0.0, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------- #
# layers (float32)
# ---------------------------------------------------------------------- #
def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x, scale, bias = normal(rng, 3, 5, 64), normal(rng, 64), normal(rng, 64)
    close(layers.rms_norm(torch.tensor(x), torch.tensor(scale), 1e-6),
          ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 2e-6)
    close(layers.layer_norm(torch.tensor(x), torch.tensor(scale),
                            torch.tensor(bias), 1e-6),
          ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias), 1e-6), 2e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 40, 4, 16)
    pos = rng.integers(0, 3000, size=(2, 40))
    close(layers.rope(torch.tensor(x), torch.tensor(pos), theta),
          ref_layers.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta),
          2e-5, 1e-5)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_mlp_gelu_is_the_tanh_form(act, gated):
    """gemma2's and recurrentgemma's GeGLU (jax.nn.gelu's tanh form), and
    the SwiGLU / plain forms the config allows."""
    rcfg, tcfg = (dataclasses.replace(c, act=act, mlp_gated=gated)
                  for c in configs("gemma2-2b", "float32"))
    p = ref_layers.init_mlp(rcfg, jax.random.PRNGKey(2))
    x = normal(np.random.default_rng(2), 2, 7, rcfg.d_model)
    close(layers.mlp(torch.tensor(x), to_torch(p), tcfg),
          ref_layers.mlp(jnp.asarray(x), p, rcfg), 2e-5, 1e-5)


def test_causal_conv1d_with_state_and_mixed_dtypes():
    """Zero history, a float32 state, and decode's bf16 input against a
    float32 state (promoted, y cast back to bf16)."""
    rng = np.random.default_rng(3)
    x, w, st = normal(rng, 2, 9, 16), normal(rng, 16, 4), normal(rng, 2, 3, 16)
    for state in (None, st):
        y, new = layers.causal_conv1d(
            torch.tensor(x), torch.tensor(w),
            None if state is None else torch.tensor(state))
        ry, rnew = ref_layers.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        close(y, ry, 1e-6)
        close(new, rnew, 0.0)
    xb = jnp.asarray(x[:, :1], jnp.bfloat16)
    ry, rnew = ref_layers.causal_conv1d(xb, jnp.asarray(w), jnp.asarray(st))
    y, new = layers.causal_conv1d(torch.tensor(np.asarray(xb, np.float32)).to(
        torch.bfloat16), torch.tensor(w), torch.tensor(st))
    assert y.dtype == torch.bfloat16 and new.dtype == torch.float32
    assert rnew.dtype == jnp.float32
    close(y, ry, 0.0)
    close(new, rnew, 0.0)


@pytest.mark.parametrize("window", [0, 16])
def test_attention_block_prefill_and_decode(window):
    """gemma2 smoke (GQA 4/2, softcap 50), global and local layers: the
    block, the prefill cache and three decode steps (the window bites
    from the first)."""
    rcfg, tcfg = configs("gemma2-2b", "float32")
    rp = ref_attn.init_attention(rcfg, jax.random.PRNGKey(4))
    tp = to_torch(rp)
    rng = np.random.default_rng(4)
    x = normal(rng, B, S, rcfg.d_model)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jpos = jnp.asarray(pos, jnp.int32)
    close(attn.attention_block(torch.tensor(x), tp, tcfg, torch.tensor(pos),
                               window=window),
          ref_attn.attention_block(jnp.asarray(x), rp, rcfg, jpos,
                                   window=window), 2e-5, 1e-5)
    out, (k, v) = attn.attention_prefill(torch.tensor(x), tp, tcfg,
                                         torch.tensor(pos), window=window,
                                         cache_len=S + 4)
    rout, (rk, rv) = ref_attn.attention_prefill(
        jnp.asarray(x), rp, rcfg, jpos, window=window, cache_len=S + 4)
    close(out, rout, 2e-5, 1e-5)
    close(k.transpose(1, 2), rk, 1e-5)
    close(v.transpose(1, 2), rv, 1e-5)
    cache, rcache = (k, v), (rk, rv)
    for t in range(3):
        xt = normal(rng, B, 1, rcfg.d_model)
        out, cache = attn.attention_decode(torch.tensor(xt), tp, tcfg, cache,
                                           S + t, window=window)
        rout, rcache = ref_attn.attention_decode(
            jnp.asarray(xt), rp, rcfg, rcache, jnp.int32(S + t),
            window=window)
        close(out, rout, 2e-5, 1e-5, f"decode step {t}")
        close(cache[0].transpose(1, 2), rcache[0], 1e-5)
        close(cache[1].transpose(1, 2), rcache[1], 1e-5)


def test_attention_with_qkv_bias_and_padded_heads():
    """The config's q/k/v biases and padded q heads (zeroed output
    rows), which no ported family uses yet, against the reference."""
    rcfg, tcfg = (dataclasses.replace(c, qkv_bias=True, n_heads_pad=6)
                  for c in configs("gemma2-2b", "float32"))
    rp = ref_attn.init_attention(rcfg, jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    rp = {k: (jnp.asarray(normal(rng, *v.shape)) if k[0] == "b" else v)
          for k, v in rp.items()}
    x = normal(rng, B, 20, rcfg.d_model)
    pos = np.broadcast_to(np.arange(20), (B, 20))
    close(attn.attention_block(torch.tensor(x), to_torch(rp), tcfg,
                               torch.tensor(pos), window=0),
          ref_attn.attention_block(jnp.asarray(x), rp, rcfg,
                                   jnp.asarray(pos, jnp.int32), window=0),
          2e-5, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_reference_shapes_and_formulas(arch):
    """The port's random init: the reference's tree (after conversion)
    key for key, shape, dtype (the MoE router float32, the codebook
    embedding and head (K, V, D) and (K, D, V)); the fixed inits equal
    (norms, D, biases, the shared experts' gate)
    or within 1e-6 (A_log, lam: log, expm1, linspace of two libraries);
    the random ones at their formula's scale."""
    rcfg, tcfg = configs(arch, "bfloat16")
    want = lm_params_from_numpy(tcfg, jax.tree.map(
        np.asarray, ref_lm.init_params(rcfg, jax.random.PRNGKey(0))), "cpu")
    got = lm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def walk(a, b, path):
        if isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], path + (k,))
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
            name = path[-1]
            if name in ("scale", "bias", "D", "ba", "bx", "bq", "bk", "bv",
                        "shared_gate"):
                assert torch.equal(a, b), path
            elif name in ("A_log", "lam"):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
            elif name == "dt_bias":       # log(expm1(U(0.001, 0.1)))
                dt = torch.nn.functional.softplus(a)
                assert 0.001 <= float(dt.min()) and float(dt.max()) <= 0.1
            elif b.numel() >= 4096:       # scaled normals
                ratio = float(a.float().std() / b.float().std())
                assert 0.9 < ratio < 1.1, (path, ratio)
    walk(got, want, ())


def test_recurrent_block_and_decode():
    rcfg, tcfg = configs("recurrentgemma-9b", "float32")
    rp = ref_rglru.init_recurrent(rcfg, jax.random.PRNGKey(5))
    tp = to_torch(rp)
    rng = np.random.default_rng(5)
    x = normal(rng, B, S, rcfg.d_model)
    close(rglru.recurrent_block(torch.tensor(x), tp, tcfg),
          ref_rglru.recurrent_block(jnp.asarray(x), rp, rcfg), 1e-4, 1e-4)
    state = rglru.init_recurrent_state(tcfg, B, "cpu")
    rstate = ref_rglru.init_recurrent_state(rcfg, B)
    for t in range(4):
        xt = normal(rng, B, 1, rcfg.d_model)
        out, state = rglru.recurrent_decode(torch.tensor(xt), tp, tcfg, state)
        rout, rstate = ref_rglru.recurrent_decode(jnp.asarray(xt), rp, rcfg,
                                                  rstate)
        close(out, rout, 2e-5, 1e-5, f"decode step {t}")
        close(state["h"], rstate["h"], 2e-5)
        close(state["conv"], rstate["conv"], 0.0)


def test_mamba_block_and_decode():
    rcfg, tcfg = configs("falcon-mamba-7b", "float32")
    rp = ref_mamba.init_mamba(rcfg, jax.random.PRNGKey(6))
    tp = to_torch(rp)
    rng = np.random.default_rng(6)
    x = normal(rng, B, S, rcfg.d_model)
    close(mamba.mamba_block(torch.tensor(x), tp, tcfg),
          ref_mamba.mamba_block(jnp.asarray(x), rp, rcfg), 1e-4, 1e-4)
    state = mamba.init_mamba_state(tcfg, B, "cpu")
    rstate = ref_mamba.init_mamba_state(rcfg, B)
    for t in range(4):
        xt = normal(rng, B, 1, rcfg.d_model)
        out, state = mamba.mamba_decode(torch.tensor(xt), tp, tcfg, state)
        rout, rstate = ref_mamba.mamba_decode(jnp.asarray(xt), rp, rcfg,
                                              rstate)
        close(out, rout, 2e-5, 1e-5, f"decode step {t}")
        close(state["ssm"], rstate["ssm"], 2e-5, 1e-5)


# ---------------------------------------------------------------------- #
# families
# ---------------------------------------------------------------------- #
def reference_loop(params, prompts, cfg, gen_tokens):
    """``repro/launch/serve.py:37-59`` on given weights and prompts:
    jitted prefill and decode, greedy argmax.  Returns the tokens, the
    prefill logits and cache, and each decode step's logits."""
    max_len = prompts.shape[1] + gen_tokens
    prefill_fn = jax.jit(lambda p, t: ref_lm.prefill(p, t, cfg, max_len))
    decode_fn = jax.jit(lambda p, t, c, i: ref_lm.decode_step(p, t, c, i,
                                                              cfg))
    logits, cache = prefill_fn(params, prompts)
    out = {"prefill_logits": np.asarray(logits),
           "prefill_cache": jax.tree.map(np.asarray, cache), "steps": []}
    cur = prompts.shape[1]
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for i in range(gen_tokens - 1):
        logits, cache = decode_fn(params, tok, cache, jnp.int32(cur + i))
        out["steps"].append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    out["tokens"] = np.concatenate(toks, axis=1)
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


FAMILIES = [(a, d) for a in SERVED for d in ("float32", "bfloat16")]


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda p: "-".join(p))
def family(request):
    """One reference run per (arch, dtype): the reference's weights and
    prompts as ``serve`` makes them (seed 0), converted for the port."""
    arch, dtype = request.param
    rcfg, tcfg = configs(arch, dtype)
    key = jax.random.PRNGKey(0)
    rparams = ref_lm.init_params(rcfg, key)
    prompts = jax.random.randint(key, (B, S), 0, rcfg.vocab_size)
    ref = reference_loop(rparams, prompts, rcfg, GEN)
    params = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, rparams),
                                  "cpu")
    return dict(arch=arch, dtype=dtype, rcfg=rcfg, tcfg=tcfg, params=params,
                prompts=torch.tensor(np.asarray(prompts)).long(), ref=ref,
                tol=TOL[dtype])


def check_cache(cache, ref_cache, cfg, tol, what):
    want = lm_cache_from_numpy(cfg, ref_cache, "cpu")
    assert len(cache) == len(want) == cfg.n_layers
    for i, (c, w) in enumerate(zip(cache, want)):
        assert c.keys() == w.keys(), (what, i)
        for name in c:
            assert c[name].dtype == w[name].dtype, (what, i, name)
            close(c[name], w[name].float().numpy(), tol["atol"], tol["rtol"],
                  f"{what}: layer {i} ({cfg.layer_types()[i]}) {name}")


def test_prefill_matches_reference(family):
    f, tol = family, family["tol"]
    logits, cache = lm.prefill(f["params"], f["prompts"], f["tcfg"], S + GEN)
    assert logits.dtype == torch.float32
    close(logits, f["ref"]["prefill_logits"], tol["logits"], 0.0, "logits")
    check_cache(cache, f["ref"]["prefill_cache"], f["tcfg"], tol, "prefill")


def test_decode_steps_match_reference(family):
    """Decode from the reference's prefill cache, fed the reference's
    tokens, so both packages see the same inputs at every step."""
    f, tol = family, family["tol"]
    cache = lm_cache_from_numpy(f["tcfg"], f["ref"]["prefill_cache"], "cpu")
    toks = f["ref"]["tokens"]
    for i, want in enumerate(f["ref"]["steps"]):
        logits, cache = lm.decode_step(f["params"],
                                       torch.tensor(toks[:, i:i + 1]).long(),
                                       cache, S + i, f["tcfg"])
        close(logits, want, tol["logits"], 0.0, f"decode step {i}")
    check_cache(cache, f["ref"]["cache"], f["tcfg"], tol, "after decode")


def test_generate_tokens_match_reference(family):
    f = family
    n0 = sum(LAUNCHES.values())
    out = generate(f["params"], f["prompts"], f["tcfg"], GEN, S + GEN)
    assert sum(LAUNCHES.values()) == n0        # the CPU launches nothing
    got, want = out["tokens"], f["ref"]["tokens"]
    assert got.shape == want.shape == (B, GEN)
    if f["dtype"] == "float32":
        np.testing.assert_array_equal(got, want)
        return
    # bf16: identical while the reference's choice is clear
    steps = [f["ref"]["prefill_logits"]] + f["ref"]["steps"]
    for b in range(B):
        for t, lg in enumerate(steps):
            top2 = np.sort(lg[b, 0])[-2:]
            if top2[1] - top2[0] <= 2 * f["tol"]["logits"]:
                break
            assert got[b, t] == want[b, t], (f["arch"], b, t)


@pytest.mark.parametrize("arch", SERVED)
def test_generate_reproduces_reference_serve(arch):
    """The reference loop above is ``serve``'s: on the reference's own
    smoke config (bf16, seed 0) both give the same tokens."""
    rcfg, _ = configs(arch, "bfloat16")
    key = jax.random.PRNGKey(0)
    params = ref_lm.init_params(rcfg, key)
    prompts = jax.random.randint(key, (B, S), 0, rcfg.vocab_size)
    want = ref_serve(arch, batch=B, prompt_len=S, gen_tokens=GEN,
                     smoke=True, seed=0)["tokens"]
    np.testing.assert_array_equal(
        reference_loop(params, prompts, rcfg, GEN)["tokens"], want)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_consistency(arch):
    """Token-by-token decode from an empty cache reproduces the prefill
    logits (the port's own paths; bf16 smoke config)."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    plog, _ = lm.prefill(params, tokens, cfg, S + 8)
    cache = lm.init_cache(cfg, B, S + 8, "cpu")
    for t in range(S):
        dlog, cache = lm.decode_step(params, tokens[:, t:t + 1], cache, t, cfg)
    assert float((plog - dlog).abs().max()) < 5e-2


def test_serve_on_the_cpu_and_unported_parts():
    """``serve`` on the CPU; only greedy decoding is served; every
    architecture of the reference resolves (the MoE layer too), and an
    unknown id raises as in the reference (no such config module)."""
    out = serve("recurrentgemma-9b", batch=2, prompt_len=20, gen_tokens=4,
                device="cpu")
    assert out["tokens"].shape == (2, 4) and out["tok_per_s"] > 0
    assert bool(torch.isfinite(out["logits"]).all())
    with pytest.raises(NotImplementedError, match="greedy"):
        serve("gemma2-2b", greedy=False, device="cpu")
    params = lm.init_params(dataclasses.replace(
        get_smoke_config("olmoe-1b-7b"), layer_pattern=("moe",)),
        torch.Generator(), "cpu")
    assert all("moe" in layer for layer in params["layers"])
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            ref_get_config(arch))
    for get in (get_config, ref_get_config):
        with pytest.raises(ModuleNotFoundError):
            get("gpt-5")
