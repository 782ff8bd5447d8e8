"""Shared building blocks: norms, activations, RoPE, MLP, causal conv.

Each function mirrors ``repro/models/layers.py`` step for step, dtype
casts included, so bf16 rounds at the same places: statistics and RoPE
in float32, results cast back to the input's dtype.  ``gelu`` is the
tanh approximation (``jax.nn.gelu``'s default), not torch's erf form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constrain import (constrain, is_dtensor, layout,
                                               local_map, model_axis_size)


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def init_normal(gen, device, dtype):
    """``normal(shape, std)``: standard normals from ``gen`` (float32),
    times ``std``, cast to ``dtype`` -- the reference's init formula."""
    def normal(shape, std):   # scaled in place: one float32 buffer
        return torch.randn(shape, generator=gen, device=device).mul_(
            std).to(dtype)
    return normal


def init_norm(cfg, device, dtype):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def init_mlp(cfg, gen, device, dtype, d_ff: int | None = None):
    """The (gated) MLP's weights; ``d_ff`` overrides ``cfg.d_ff``
    (Qwen2-MoE's shared experts are one MLP of ``n_shared * d_expert``)."""
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    normal = init_normal(gen, device, dtype)
    p = {"up": normal((d, f), d ** -0.5), "down": normal((f, d), f ** -0.5)}
    if cfg.mlp_gated:
        p["gate"] = normal((d, f), d ** -0.5)
    return p


def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, p, cfg):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": gelu}[name]


def rope(x, positions, theta: float):
    """Rotary embeddings.  x: (..., S, H, Dh), Dh even; positions (..., S).

    The frequencies are ``theta ** (-arange(half) / half)`` in float32,
    as the reference computes them (a float64 pow rounds differently).
    """
    half = x.shape[-1] // 2
    expo = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), expo)
    ang = positions[..., None].float() * freq              # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(x, p, cfg):
    a = act_fn(cfg.act)
    if cfg.mlp_gated:
        h = a(x @ p["gate"]) * (x @ p["up"])
    else:
        h = a(x @ p["up"])
    return row_parallel(h, p["down"])


def _mm_f32(x, w):
    """x @ w with float32 products and sums, float32 out: on the card a
    half-precision GEMM's own float32 output (``torch.mm(...,
    out_dtype=)``); the CPU has no such GEMM, so there, and for float32
    operands, the operands are upcast."""
    if x.is_cuda and x.dtype != torch.float32:
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1],
                                                         w.shape[-1])
    return x.float() @ w.float()


def row_parallel(x, w):
    """``x @ w`` for a weight whose rows shard over 'model' (the second
    product of a tensor-parallel pair).  When serving (no autograd) under
    a mesh whose 'model' axis is split, each rank forms its partial
    product in float32 and the partial sums are reduced in float32, then
    rounded once to x's dtype, as one card's product rounds: bf16
    partial sums each rounded and then summed moved full-width logits by
    up to ~20% of their RMS from one card's.  Else ``x @ w``: training
    keeps DTensor's own product and the backward DTensor derives for it,
    the form the sharded train step is held to on the card."""
    if model_axis_size() <= 1 or not is_dtensor(x) or \
            torch.is_grad_enabled():
        return x @ w
    lead = ("dp",) + (None,) * (x.dim() - 2)
    part = local_map(_mm_f32, layout(*lead, None, partial=("model",)),
                     (layout(*lead, "model"), layout("model", None)))(x, w)
    return constrain(part, *lead, None).to(x.dtype)


def causal_conv1d(x, w, state=None):
    """Depthwise causal temporal conv.

    x: (B, S, D); w: (D, K).  ``state`` (B, K-1, D) holds the trailing
    inputs of the previous chunk (zeros when None).  History and input
    are joined in their promoted dtype, as ``jnp.concatenate`` does (a
    float32 decode state with a bf16 input gives a float32 state); y is
    summed in float32 and cast to x's dtype.  Returns (y, new_state).
    """
    b, s, d = x.shape
    k = w.shape[1]
    if state is None:
        state = x.new_zeros((b, k - 1, d))
    dt = torch.promote_types(state.dtype, x.dtype)
    xx = torch.cat([state.to(dt), x.to(dt)], dim=1)         # (B, S+K-1, D)
    wf = w.float()
    y = torch.zeros((b, s, d), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xx[:, i:i + s, :].float() * wf[:, i]
    new_state = xx[:, xx.shape[1] - (k - 1):, :]
    return y.to(x.dtype), new_state


def conv1d_on_channels(x, w, state, ch):
    """:func:`causal_conv1d` on each rank's rows and channels under a
    mesh (``ch`` the channels' axis, or None), its state float32."""
    rows = layout("dp", None, ch)
    ins = (rows, layout(ch, None)) + ((rows,) if state is not None else ())

    def fn(x, w, state=None):
        y, st = causal_conv1d(x, w, state)
        return y, st.float()
    return local_map(fn, (rows, rows), ins)(x, w, *(
        (state,) if state is not None else ()))
