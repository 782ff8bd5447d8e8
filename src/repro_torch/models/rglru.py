"""Griffin recurrent block (recurrentgemma): conv + RG-LRU recurrence.

Mirrors ``repro/models/rglru.py``.  Two input branches -- a GeLU gate
and a temporal branch (causal conv1d -> RG-LRU) -- merged
multiplicatively, then projected out:

    r_t = sigmoid(W_a y_t + b_a),   i_t = sigmoid(W_x y_t + b_x)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

Prefill runs the recurrence through the RG-LRU kernel
(:mod:`repro_torch.kernels.rglru_scan`); decode is the single-step
update in plain PyTorch, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru
from repro_torch.models.layers import causal_conv1d, gelu, init_normal

RGLRU_C = 8.0


def init_recurrent(cfg, gen, device, dtype):
    d, w, kc = cfg.d_model, cfg.lru_width_, cfg.ssm_conv
    normal = init_normal(gen, device, dtype)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_gate": normal((d, w), d ** -0.5),
        "in_lin": normal((d, w), d ** -0.5),
        "conv_w": normal((w, kc), kc ** -0.5),
        "wa": normal((w, w), w ** -0.5),
        "ba": torch.zeros((w,), **f32),
        "wx": normal((w, w), w ** -0.5),
        "bx": torch.zeros((w,), **f32),
        # Lambda so that a^c spans ~(0.9, 0.999) (Griffin appendix)
        "lam": torch.log(torch.expm1(torch.linspace(0.35, 0.9, w, **f32))),
        "out_proj": normal((w, d), w ** -0.5),
    }


def _gates(y, p):
    r = torch.sigmoid((y @ p["wa"]).float() + p["ba"])
    i = torch.sigmoid((y @ p["wx"]).float() + p["bx"])
    a = torch.exp(-RGLRU_C * F.softplus(p["lam"]) * r)
    return a, i


def recurrent_prefill(x, p, cfg):
    """Over the prompt.  x (B, S, D) -> (out (B, S, D), state for decode:
    ``conv`` (B, K-1, W) and ``h`` (B, W), float32)."""
    gate = gelu((x @ p["in_gate"]).float()).to(x.dtype)
    z, conv = causal_conv1d(x @ p["in_lin"], p["conv_w"])
    a, i = _gates(z, p)
    h = rglru(i * z.float(), a)                            # (B, S, W) f32
    out = (h.to(x.dtype) * gate) @ p["out_proj"]
    return out, {"conv": conv.float(), "h": h[:, -1]}


def recurrent_block(x, p, cfg):
    """Forward without the state.  x: (B, S, D) -> (B, S, D)."""
    return recurrent_prefill(x, p, cfg)[0]


def init_recurrent_state(cfg, batch, device, dtype=torch.float32):
    w = cfg.lru_width_
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def recurrent_decode(x, p, cfg, state):
    """One token.  x (B, 1, D) -> (out, new state)."""
    gate = gelu((x @ p["in_gate"]).float()).to(x.dtype)
    y, conv_state = causal_conv1d(x @ p["in_lin"], p["conv_w"], state["conv"])
    a, i = _gates(y, p)                                    # (B, 1, W)
    u = i[:, 0] * y[:, 0].float()
    a0 = a[:, 0]
    h = a0 * state["h"] + torch.sqrt(torch.clamp(1.0 - a0 * a0, min=0.0)) * u
    out = (h[:, None].to(x.dtype) * gate) @ p["out_proj"]
    return out, {"conv": conv_state, "h": h}
