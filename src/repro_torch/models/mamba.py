"""Mamba-1 block (falcon-mamba): gated selective state-space layer.

Mirrors ``repro/models/mamba.py``.  The training form
(:func:`mamba_block`) is the reference's sequential scan carrying the
float32 (B, Di, N) state, in plain PyTorch, so autograd differentiates
it.  Prefill scans the whole prompt in one call
of the selective-scan kernel (:mod:`repro_torch.kernels.mamba_scan`),
which also returns the final state; the reference gets that state from
a second scan.  Decode is the single-step update in plain PyTorch, as
in the reference.  Under a mesh the conv, the scan (prefill) and the
step (decode) run on each rank's rows and channels
(:func:`repro_torch.distributed.constrain.local_map`), the placements of
the training form's scan, and the ``conv`` / ``ssm`` states are laid out
as ``cache_pspecs`` says (rows over the data axes, channels over
'model').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constrain import (constrain, layout, local_map,
                                               model_axis_size)
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.models.layers import (causal_conv1d, conv1d_on_channels,
                                       init_normal, row_parallel)


def init_mamba(cfg, gen, device, dtype):
    d, di, n, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    kc = cfg.ssm_conv
    normal = init_normal(gen, device, dtype)

    f32 = dict(dtype=torch.float32, device=device)
    dt = torch.rand((di,), generator=gen, **f32) * 0.099 + 0.001
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((di, kc), kc ** -0.5),
        "x_proj": normal((di, dtr + 2 * n), di ** -0.5),
        "dt_proj": normal((dtr, di), dtr ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.clamp(dt, min=1e-4))),
        "A_log": torch.log(torch.arange(1, n + 1, **f32).repeat(di, 1)),
        "D": torch.ones((di,), **f32),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _in_proj(x, p):
    """(u, z), each (B, S, Di); under a mesh the column-parallel product
    is gathered over 'model' before it is split in two (u's channels and
    z's are not each rank's own columns of ``in_proj``)."""
    return constrain(x @ p["in_proj"], "dp", None, None).chunk(2, dim=-1)


def _ssm_inputs(u, p, cfg):
    """Project the conv output to (delta, B, C); delta's softplus runs in
    u's dtype, as the reference's does.  Under a mesh the row-parallel
    product is reduced over 'model' before it is split."""
    n, dtr = cfg.ssm_state, cfg.dt_rank
    dt_in, b_in, c_in = constrain(row_parallel(u, p["x_proj"]), "dp", None,
                                  None).split([dtr, n, n], dim=-1)
    delta = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].to(dt_in.dtype))
    return delta, b_in, c_in


def _channels(cfg):
    """The channels' mesh axis: 'model' when it divides d_inner."""
    m = model_axis_size()
    return "model" if m and cfg.d_inner % m == 0 else None


def _scan_layout(ch):
    """Placements of (u, delta, A, B, C, D): rows and channels, B and C
    whole on every rank."""
    rows, bc = ("dp", None, ch), ("dp", None, None)
    return [layout(*rows), layout(*rows), layout(ch, None), layout(*bc),
            layout(*bc), layout(ch)]


def mamba_prefill(x, p, cfg):
    """Over the prompt.  x (B, S, D) -> (out (B, S, D), state for decode:
    ``conv`` (B, K-1, Di), the last pre-conv inputs, and ``ssm`` (B, Di,
    N), both float32)."""
    ch = _channels(cfg)
    u, z = _in_proj(x, p)             # (B, S, Di) each
    uc, conv = conv1d_on_channels(u, p["conv_w"], None, ch)
    uc = F.silu(uc)
    delta, b_in, c_in = _ssm_inputs(uc, p, cfg)
    y, h = local_map(selective_scan,
                     (layout("dp", None, ch), layout("dp", ch, None)),
                     tuple(_scan_layout(ch)))(
        uc, delta, -torch.exp(p["A_log"]), b_in, c_in, p["D"])
    y = y.to(x.dtype) * F.silu(z)
    return row_parallel(y, p["out_proj"]), {"conv": conv, "ssm": h}


def _scan(uf, df, A, bf, cf, D):
    """The float32 recurrence over the steps of (B, S, Di) inputs."""
    h = uf.new_zeros((uf.shape[0], uf.shape[2], A.shape[1]))
    ys = []
    for t in range(uf.shape[1]):
        u_t, d_t = uf[:, t], df[:, t]
        h = torch.exp(d_t[..., None] * A[None]) * h \
            + (d_t * u_t)[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + D[None] * u_t)
    return torch.stack(ys, dim=1)


def mamba_block(x, p, cfg):
    """The training form (no state), the reference's ``mamba_block``.
    x: (B, S, D) -> (B, S, D).  Each step updates the float32 state
    ``h = exp(dt A) h + (dt u) B`` and emits ``y = h . C + D u``.  The
    reference scans in 512-step chunks, the state carried across them,
    which bounds its scan's memory; one loop over the steps is the same
    arithmetic.  Under a mesh the loop runs on each rank's rows and
    channels (:func:`repro_torch.distributed.constrain.local_map`), B and
    C whole on every rank: the gradients of A and D are then partial
    over the data axes, those of B and C over the channels' axis."""
    u, z = _in_proj(x, p)             # (B, S, Di) each
    u, _ = causal_conv1d(u, p["conv_w"])
    u = F.silu(u)
    delta, b_in, c_in = _ssm_inputs(u, p, cfg)
    A = -torch.exp(p["A_log"])
    ch = _channels(cfg)
    rows, bc = ("dp", None, ch), ("dp", None, None)
    ins = _scan_layout(ch)
    grads = ins[:2] + [layout(ch, None, partial=("dp",)),
                       layout(*bc, partial=(ch,)),
                       layout(*bc, partial=(ch,)), layout(ch, partial=("dp",))]
    y = local_map(_scan, layout(*rows), tuple(ins), tuple(grads))(
        u.float(), delta.float(), A, b_in.float(), c_in.float(), p["D"])
    y = y.to(x.dtype) * F.silu(z)
    return row_parallel(y, p["out_proj"])


def init_mamba_state(cfg, batch, device, dtype=torch.float32):
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                               dtype=dtype, device=device)}


def _step(u, delta, A, b_in, c_in, D, h):
    """One step of the recurrence: (B, 1, Di) inputs, state h (B, Di, N)
    -> (y (B, 1, Di) float32, h)."""
    dt0 = delta[:, 0].float()                              # (B, Di)
    u0 = u[:, 0].float()
    h = torch.exp(dt0[..., None] * A) * h \
        + (dt0 * u0)[..., None] * b_in[:, 0].float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_in[:, 0].float()) + D * u0
    return y[:, None], h


def mamba_decode(x, p, cfg, state):
    """One token.  x (B, 1, D) -> (out, new state)."""
    ch = _channels(cfg)
    u, z = _in_proj(x, p)             # (B, 1, Di)
    u, conv_state = conv1d_on_channels(u, p["conv_w"], state["conv"], ch)
    u = F.silu(u)
    delta, b_in, c_in = _ssm_inputs(u, p, cfg)
    hs = layout("dp", ch, None)
    y, h = local_map(_step, (layout("dp", None, ch), hs),
                     tuple(_scan_layout(ch)) + (hs,))(
        u, delta, -torch.exp(p["A_log"]), b_in, c_in, p["D"], state["ssm"])
    y = y.to(x.dtype) * F.silu(z)
    return row_parallel(y, p["out_proj"]), {"conv": conv_state, "ssm": h}
