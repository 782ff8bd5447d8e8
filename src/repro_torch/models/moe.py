"""Mixture-of-experts MLP: top-k token choice, grouped capacity dispatch.

Mirrors ``repro/models/moe.py`` (GShard, arXiv:2006.16668): the tokens
split into ``n_groups`` routing groups, each with its own capacity
``int(1.25 * k * T_g / E) + 1``; an assignment's position in its expert
is the exclusive cumsum of the one-hot over the group's flat
``(token, choice)`` axis, token-major, so an overflowing expert drops
the later tokens of a group.  OLMoE (64 routed, top-8, gates
renormalized) and Qwen2-MoE (60 routed, top-4, plus shared experts
behind a sigmoid gate).

The reference scatter-adds into the dispatch buffer and again into the
output.  Here each kept ``(group, expert, rank)`` slot receives exactly
one token, so the dispatch is an assignment (the dropped assignments go
to one spare row, which is cut off), and the combine sums each token's
k choices in choice order, ``((0 + c_0) + c_1) + ...``, the order the
reference's ``.at[].add`` takes them in: no atomics, the bits repeat on
the card.  The expert products are batched matmuls over the experts
(the reference's einsums; it has no kernel here either).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constrain import (constrain, dp_dividing, layout,
                                               local_map, model_axis_size)
from repro_torch.models.layers import act_fn, init_mlp, init_normal, mlp

CAPACITY_FACTOR = 1.25


def init_moe(cfg, gen, device, dtype):
    d, de, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    ep = max(cfg.n_experts_pad, e)   # dummy experts make E divide the EP axis
    normal = init_normal(gen, device, dtype)
    s_in, s_out = d ** -0.5, de ** -0.5
    p = {"router": init_normal(gen, device, torch.float32)((d, e), s_in),
         "gate": normal((ep, d, de), s_in),
         "up": normal((ep, d, de), s_in),
         "down": normal((ep, de, d), s_out)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, gen, device, dtype,
                               d_ff=cfg.n_shared_experts * cfg.d_expert)
        p["shared_gate"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def n_groups(cfg, t: int) -> int:
    """``cfg.moe_groups`` halved until it divides the ``t`` tokens."""
    g = max(int(getattr(cfg, "moe_groups", 16) or 16), 1)
    while t % g:
        g //= 2
    return max(g, 1)


def route(xt, router, k: int, n_experts: int, capacity: int):
    """The routing of ``xt`` (g, tl, D): float32 router probabilities
    (g, tl, E), the top-k experts ``idx`` and renormalized gates (g, tl,
    k), and over the flat (g, tl * k) axis each assignment's ``rank`` in
    its expert and ``keep`` (rank < capacity), with the one-hot ``oh``
    (g, tl * k, E) the aux loss counts."""
    g, tl, _ = xt.shape
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(g, tl * k)
    oh = F.one_hot(flat_e, n_experts)
    rank = (torch.cumsum(oh, dim=1) - oh).gather(-1, flat_e[..., None])[..., 0]
    return dict(probs=probs, idx=idx, gates=gates, rank=rank,
                keep=rank < capacity, oh=oh)


def _dispatch(xt, router, k: int, e: int, ep: int, cap: int):
    """Route the groups ``xt`` (g, tl, D) and fill their expert buffer
    (g, E_pad, C, D).  Returns the buffer, each assignment's ``slot``
    and ``keep`` and its gate (g, tl * k), and the router probabilities
    and one-hot the aux loss reads."""
    g, tl, d = xt.shape
    r = route(xt, router, k, e, cap)
    flat_e, keep = r["idx"].reshape(g, tl * k), r["keep"]
    flat_g = r["gates"].reshape(g, tl * k)
    dev = xt.device
    gi = torch.arange(g, device=dev)[:, None]
    tok = gi * tl + torch.arange(tl, device=dev).repeat_interleave(k)[None]

    # dispatch: slot (g, e, rank) of a (g * E_pad * C + 1, D) buffer, the
    # last row the dropped assignments' (and cut off); padded experts'
    # rows stay zero (the router never picks them)
    slot = (gi * ep + flat_e) * cap + r["rank"]
    spare = g * ep * cap
    slot = torch.where(keep, slot, spare)
    buf = xt.new_zeros((spare + 1, d))
    buf[slot.reshape(-1)] = xt.reshape(g * tl, d)[tok.reshape(-1)]
    return (buf[:spare].reshape(g, ep, cap, d), slot, keep, flat_g,
            r["probs"], r["oh"])


def _experts(buf, w_gate, w_up, w_down, act: str):
    """Every expert's MLP over its rows of the (g, E, C, D) buffer."""
    g, ep, cap, d = buf.shape
    a = act_fn(act)
    xe = buf.transpose(0, 1).reshape(ep, g * cap, d)        # per expert
    h = a(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    out_e = torch.bmm(h, w_down)                            # (E, g*C, D)
    return out_e.reshape(ep, g, cap, d).transpose(0, 1)


def _combine(out_buf, slot, keep, flat_g, k: int, s: int):
    """Each token's k choices summed in choice order, float32; (B, S, D)
    rows in the buffer's dtype."""
    g, _, _, d = out_buf.shape
    tl = slot.shape[1] // k
    safe = torch.where(keep, slot, 0).reshape(-1)
    contrib = (out_buf.reshape(-1, d)[safe].reshape(g, tl * k, d)
               * flat_g[..., None].to(out_buf.dtype)
               * keep[..., None].to(out_buf.dtype)).float().reshape(
                   g, tl, k, d)
    acc = contrib[:, :, 0]
    for j in range(1, k):
        acc = acc + contrib[:, :, j]
    return acc.to(out_buf.dtype).reshape(-1, s, d)


def moe_mlp(x, p, cfg, capacity_factor: float = CAPACITY_FACTOR):
    """x (B, S, D) -> (out (B, S, D), aux), on x's device.

    Under a mesh each stage runs on local shards
    (:func:`repro_torch.distributed.constrain.local_map`): the routing,
    dispatch and combine on each rank's groups (batch over the data
    axes), the experts on its groups and, when they divide 'model', its
    experts (expert parallelism, the reference's layout), the experts'
    outputs gathered over 'model' for the combine.  Groups that do not
    divide the data ranks (16 groups on the 32 of two pods) shard over
    the data axes they divide and repeat over the others
    (:func:`repro_torch.distributed.constrain.dp_dividing`)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ep = max(cfg.n_experts_pad, e)
    t = b * s
    g = n_groups(cfg, t)
    tl = t // g
    cap = int(capacity_factor * k * tl / e) + 1
    ga = dp_dividing(g)
    xt = constrain(constrain(x, ga, None, None).reshape(g, tl, d), ga, None,
                   None)
    m = model_axis_size()
    ea = "model" if m and ep % m == 0 else None
    grp, grp2 = layout(ga, None, None), layout(ga, None)
    buf, slot, keep, flat_g, probs, oh = local_map(
        lambda xt, router: _dispatch(xt, router, k, e, ep, cap),
        (layout(ga, None, None, None), grp2, grp2, grp2, grp, grp),
        (grp, layout()), (grp, layout(partial=(ga,))))(xt, p["router"])
    w_axes = (ea, None, None)
    ex = layout(ga, ea, None, None)
    out_buf = local_map(
        lambda *a: _experts(*a, cfg.act), ex, (ex,) + (layout(*w_axes),) * 3,
        (ex,) + (layout(*w_axes, partial=(ga,)),) * 3)(
            buf, p["gate"], p["up"], p["down"])
    out = local_map(
        lambda *a: _combine(*a, k, s), grp,
        (layout(ga, None, None, None), grp2, grp2, grp2))(
            out_buf, slot, keep, flat_g)
    out = constrain(out, "dp", None, None)     # rows laid out as x's

    if cfg.n_shared_experts:   # on (B, S, D): the same products as on
        # the flattened tokens, with no reshape for DTensor to lay out; the
        # gate's rows (and so its gradient's) laid out as x's
        gate_sh = torch.sigmoid(constrain(x @ p["shared_gate"], "dp",
                                          None).float())
        out = out + mlp(x, p["shared"], cfg) * gate_sh[..., None].to(x.dtype)

    # Switch-style load-balance loss; dropped assignments count too
    me = probs.mean(dim=(0, 1))
    ce = oh.sum(dim=(0, 1)).float() / (t * k)
    return out, e * torch.sum(me * ce)
