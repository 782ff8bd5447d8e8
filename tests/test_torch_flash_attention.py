"""The port's attention (plain version and CPU dispatch) against the
reference's.

Each case of ``tests/test_kernels.py``'s sweep goes through the port's
plain version and through the reference's Pallas kernel in interpret
mode and its ``mha_ref`` oracle, at that file's bars (float32 2e-5,
bf16 3e-2).  The chunked jnp attention the reference's layers really
run is held the same way.  A fully masked row outputs 0 (the port's
contract; the reference returns the mean of v there, ROADMAP Queue 3).
The CUDA kernel's checks are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention.ops import attention as ref_attention  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    DECODE_KEYS, MIN_SPLIT, attention_form, decode_splits)
from repro_torch.kernels.flash_attention.ops import attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# tests/test_kernels.py:44-53, and D = 160
CASES = {
    "mha": dict(b=1, hq=4, hkv=4, sq=64, skv=64, d=32),
    "gqa": dict(b=2, hq=8, hkv=2, sq=64, skv=64, d=32),
    "mqa_pad": dict(b=1, hq=4, hkv=1, sq=48, skv=48, d=64),
    "window": dict(b=1, hq=4, hkv=2, sq=64, skv=64, d=32, window=16),
    "softcap": dict(b=1, hq=4, hkv=4, sq=64, skv=64, d=32, softcap=50.0),
    "decode": dict(b=1, hq=4, hkv=2, sq=1, skv=100, d=32),
    "window_offset": dict(b=1, hq=2, hkv=2, sq=40, skv=104, d=64, window=32),
    "noncausal": dict(b=1, hq=2, hkv=2, sq=64, skv=64, d=32, causal=False),
    # stablelm-12b's head dim (GQA 32/8 at full width)
    "d160": dict(b=1, hq=4, hkv=1, sq=64, skv=64, d=160),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(case, seed=0):
    c = dict(case)
    b, hq, hkv = c.pop("b"), c.pop("hq"), c.pop("hkv")
    sq, skv, d = c.pop("sq"), c.pop("skv"), c.pop("d")
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    return q, k, v, c


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret_and_mha_ref(name, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, opts = _inputs(CASES[name])
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    pal = _f32(ref_attention(jq, jk, jv, backend="pallas_interpret",
                             block_q=32, block_kv=32, **opts))
    oracle = _f32(ref_attention(jq, jk, jv, backend="ref", **opts))
    # the same (rounded) inputs on the port's side
    tq, tk, tv = (torch.tensor(_f32(a)).to(tdt) for a in (jq, jk, jv))
    n0 = sum(LAUNCHES.values())
    got = attention(tq, tk, tv, **opts)
    assert sum(LAUNCHES.values()) == n0      # the CPU launches nothing
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    assert np.abs(got - pal).max() < tol, (name, dtype)
    assert np.abs(got - oracle).max() < tol, (name, dtype)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 50.0),
                                            (24, 50.0)])
def test_plain_matches_chunked_production_path(window, softcap):
    """The jnp attention the reference's layers run (B, S, H, D layout,
    window 0 = none), at the float32 bar."""
    rng = np.random.default_rng(1)
    b, hq, hkv, s, d = 2, 8, 2, 96, 32
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    want = np.asarray(chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, softcap=softcap, q_chunk=32, kv_chunk=32))
    heads_first = lambda a: torch.as_tensor(a).transpose(1, 2)  # noqa: E731
    got = attention(heads_first(q), heads_first(k), heads_first(v),
                    causal=True, window=window, softcap=softcap)
    assert np.abs(got.transpose(1, 2).numpy() - want).max() < 2e-5


def test_fully_masked_row_outputs_zero():
    """q 8 x kv 4, causal: queries 0-3 sit before every key.  The port's
    contract is 0 there (the reference's mha_ref and chunked attention
    return the mean of v, its Pallas kernel half of that)."""
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(1, 1, 4, 16)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(1, 1, 4, 16)).astype(np.float32))
    out = attention_ref(q, k, v, causal=True)
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    # rows with keys are the softmax over those keys
    s = torch.einsum("bhd,bkd->bhk", q[0, :, 7:8].reshape(2, 1, 16),
                     k[0].expand(2, 4, 16)) * 16 ** -0.5
    want = torch.softmax(s, dim=-1) @ v[0].expand(2, 4, 16)
    torch.testing.assert_close(out[0, :, 7], want[:, 0], rtol=0, atol=1e-6)


def test_dispatch_takes_strided_views_and_window_zero():
    """The layers pass transposed views and window 0 for global layers."""
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.normal(size=(2, 10, 4, 16)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(2, 10, 2, 16)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(2, 10, 2, 16)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    dense = [t.contiguous() for t in views]
    for window in (0, None):
        torch.testing.assert_close(attention(*views, window=window),
                                   attention_ref(*dense), rtol=0, atol=0)
    torch.testing.assert_close(attention(*views, window=4),
                               attention_ref(*dense, window=4), rtol=0,
                               atol=0)


@pytest.mark.parametrize("band,rows,n_sm,want", [
    (1, 1, 132, (1, 16)), (2048, 4, 132, (64, 32)),
    (3104, 16, 132, (49, 64)), (65, 8, 132, (5, 16)),
    (100000, 4, 132, (1563, 64)), (16, 264, 132, (1, 16))])
def test_decode_splits(band, rows, n_sm, want):
    splits, length = decode_splits(band, rows, n_sm)
    assert (splits, length) == want
    assert MIN_SPLIT <= length <= DECODE_KEYS and length % MIN_SPLIT == 0
    assert (splits - 1) * length < band <= splits * length   # none empty
    # two blocks per SM where the keys allow, but for the rounding of the
    # length up to a multiple of MIN_SPLIT, which at most halves them
    assert 2 * splits * rows >= min(2 * n_sm, rows * -(-band // MIN_SPLIT))


def test_decode_splits_rejects_empty():
    with pytest.raises(ValueError):
        decode_splits(0, 4, 132)


@pytest.mark.parametrize("sq,dtype,form", [
    (1, torch.bfloat16, "decode"), (1, torch.float32, "cuda_core"),
    (2, torch.bfloat16, "mma"), (3072, torch.bfloat16, "mma"),
    (2, torch.float32, "cuda_core"), (3072, torch.float32, "cuda_core")])
def test_attention_form(sq, dtype, form):
    assert attention_form(sq, dtype) == form
