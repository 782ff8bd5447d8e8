"""Griffin recurrent block (recurrentgemma): conv + RG-LRU recurrence.

Mirrors ``repro/models/rglru.py``.  Two input branches -- a GeLU gate
and a temporal branch (causal conv1d -> RG-LRU) -- merged
multiplicatively, then projected out:

    r_t = sigmoid(W_a y_t + b_a),   i_t = sigmoid(W_x y_t + b_x)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

The training form (:func:`recurrent_block`) runs the recurrence as the
reference does, an associative scan (:func:`rglru_assoc_scan`, plain
PyTorch, so autograd differentiates it).  Prefill runs it through the
RG-LRU kernel (:mod:`repro_torch.kernels.rglru_scan`); decode is the
single-step update in plain PyTorch, as in the reference.  Under a mesh
the conv, the scan and the step run on each rank's rows and channels
(:func:`repro_torch.distributed.constrain.local_map`), the training
form's placements, and the ``conv`` / ``h`` states are laid out as
``cache_pspecs`` says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constrain import (constrain, layout, local_map,
                                               model_axis_size)
from repro_torch.kernels.rglru_scan.ops import rglru
from repro_torch.models.layers import (causal_conv1d, conv1d_on_channels,
                                       gelu, init_normal, row_parallel)

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
    # under a mesh the channel-sharded input is gathered over 'model' for
    # the column-parallel gates (the layout every rank's torch can place)
    y = constrain(y, "dp", None, None)
    r = torch.sigmoid((y @ p["wa"]).float() + p["ba"])
    i = torch.sigmoid((y @ p["wx"]).float() + p["bx"])
    a = torch.exp(-RGLRU_C * F.softplus(p["lam"]) * r)
    return a, i


def _channels(cfg):
    """The channels' mesh axis: 'model' when it divides the width."""
    m = model_axis_size()
    return "model" if m and cfg.lru_width_ % m == 0 else None


def recurrent_prefill(x, p, cfg):
    """Over the prompt.  x (B, S, D) -> (out (B, S, D), state for decode:
    ``conv`` (B, K-1, W) and ``h`` (B, W), float32)."""
    ch = _channels(cfg)
    gate = gelu((x @ p["in_gate"]).float()).to(x.dtype)
    z, conv = conv1d_on_channels(x @ p["in_lin"], p["conv_w"], None, ch)
    a, i = _gates(z, p)
    rows = layout("dp", None, ch)

    def scan(x, a):
        h = rglru(x, a)
        return h, h[:, -1]
    h, last = local_map(scan, (rows, layout("dp", ch)), (rows, rows))(
        i * z.float(), a)                                  # (B, S, W) f32
    out = row_parallel(h.to(x.dtype) * gate, p["out_proj"])
    return out, {"conv": conv, "h": last}


def rglru_assoc_scan(x, a):
    """Every state h_t of the RG-LRU recurrence, (B, S, W) float32, as a
    log-depth scan: ``log2 S`` doubling steps of the reference's
    associative combine ``(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)``
    (``repro/kernels/rglru_scan/ref.py``), each out of place, so the
    autograd graph holds O(S log S) elements, not an S-step loop."""
    a = a.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x.float()
    d = 1
    while d < a.shape[1]:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return b


def recurrent_block(x, p, cfg):
    """The training form (no state), the reference's ``recurrent_block``.
    x: (B, S, D) -> (B, S, D).  Under a mesh the scan runs on each rank's
    rows and channels (:func:`repro_torch.distributed.constrain.local_map`)."""
    gate = gelu((x @ p["in_gate"]).float()).to(x.dtype)
    z, _ = causal_conv1d(x @ p["in_lin"], p["conv_w"])
    a, i = _gates(z, p)
    rows = ("dp", None, _channels(cfg))
    h = local_map(rglru_assoc_scan, layout(*rows),
                  (layout(*rows), layout(*rows)))(
        i * z.float(), a)                                  # (B, S, W) f32
    return row_parallel(h.to(x.dtype) * gate, p["out_proj"])


def init_recurrent_state(cfg, batch, device, dtype=torch.float32):
    w = cfg.lru_width_
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def _step(i, y, a, h):
    """One step of the recurrence: gates and input (B, 1, W), state h
    (B, W) -> h."""
    u = i[:, 0] * y[:, 0].float()
    a0 = a[:, 0]
    return a0 * h + torch.sqrt(torch.clamp(1.0 - a0 * a0, min=0.0)) * u


def recurrent_decode(x, p, cfg, state):
    """One token.  x (B, 1, D) -> (out, new state)."""
    ch = _channels(cfg)
    gate = gelu((x @ p["in_gate"]).float()).to(x.dtype)
    y, conv_state = conv1d_on_channels(x @ p["in_lin"], p["conv_w"],
                                       state["conv"], ch)
    a, i = _gates(y, p)                                    # (B, 1, W)
    rows, hs = layout("dp", None, ch), layout("dp", ch)
    h = local_map(_step, hs, (rows, rows, rows, hs))(i, y, a, state["h"])
    out = row_parallel(h[:, None].to(x.dtype) * gate, p["out_proj"])
    return out, {"conv": conv_state, "h": h}
