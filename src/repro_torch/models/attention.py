"""Attention layers: the chunked training form, prefill (cache
construction) and cached decode.

Mirrors ``repro/models/attention.py``, its sharding constraints
included: under a mesh (:func:`repro_torch.distributed.constrain.use_mesh`)
with DTensor inputs, q is sharded over 'model' on the flat q-head axis
when the (padded) head count divides it, else computed replicated over
'model' (the reference's fallback); k/v are sharded over 'model' on
their heads when those divide it, else replicated over 'model', and
each rank takes (or repeats) the kv heads of its own q heads.  The
projections are laid out so before the reshape to heads, so a reshape
never cuts inside a head.  Every activation is batch-sharded over the
data axes; on plain tensors the constraints return their input.
:func:`attention_block`, the training form, is the reference's chunked
online softmax in plain PyTorch (:func:`chunked_attention`), so autograd
differentiates it on any device; the attention kernel has no backward.
Prefill and decode go through
:func:`repro_torch.kernels.flash_attention.ops.attention`, decode with
Sq = 1 on the live slice of the cache; under a mesh on each rank's
local shards (:func:`repro_torch.distributed.constrain.local_map`).

The KV cache is stored ``(B, Hkv, Smax, Dh)`` (the reference's is
``(B, Smax, Hkv, Dh)``) so that slice is a strided view, and decode
writes each new key and value into it in place.  Under a mesh the cache
is laid out as ``cache_pspecs`` says: batch over the data axes, kv heads
over 'model' (head_dim when the heads do not divide it), or, for a
batch the data axes do not divide (``batch_rows``), the sequence over
the data axes.  A head_dim-sharded cache gathers its live slice's
head_dim over 'model' each decode step (a dot product needs the whole
head_dim); a sequence-sharded one attends on each rank's slice and
merges the ranks' partial softmaxes by two small all-reduces (the
row log-sum-exp's max, then the weighted outputs and weights), never
gathering the cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constrain import (active_mesh, axes_size,
                                               axis_rank, batch_replicated,
                                               constrain, data_axes,
                                               is_dtensor, layout, local_map,
                                               model_axis_size)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import init_normal, rope, row_parallel

NEG_INF = -1e30


def init_attention(cfg, gen, device, dtype):
    d, dh = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    np_ = _nq(cfg)
    s = d ** -0.5
    normal = init_normal(gen, device, dtype)

    wq = normal((d, np_ * dh), s)
    wk = normal((d, nkv * dh), s)
    wv = normal((d, nkv * dh), s)
    wo = normal((nq * dh, d), (nq * dh) ** -0.5)
    if np_ > nq:     # padded q heads get zeroed output rows
        wo = torch.cat([wo, wo.new_zeros(((np_ - nq) * dh, d))])
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((np_ * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((nkv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((nkv * dh,), dtype=dtype, device=device)
    return p


def _nq(cfg):
    return max(cfg.n_heads_pad, cfg.n_heads)


def _head_axis(cfg):
    """'model' if the (padded) q-head axis divides the model mesh axis,
    else None (replicated attention fallback)."""
    m = model_axis_size()
    if m and _nq(cfg) % m == 0:
        return "model"
    return None


def _kv_axis(cfg):
    """'model' if the kv heads shard over it (they divide it and so do
    the q heads), else None (k/v replicated over 'model')."""
    m = model_axis_size()
    if _head_axis(cfg) and cfg.n_kv_heads % m == 0:
        return "model"
    return None


def _project_qkv(x, p, cfg, positions):
    """(B, S, D) -> q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh), roped.

    Under a mesh each projection is laid out before the reshape to
    heads: over 'model' on its flat head axis only when its heads divide
    'model' (each rank then holds whole heads), else replicated over it."""
    b, s, _ = x.shape
    dh = cfg.head_dim_
    ha, kva = _head_axis(cfg), _kv_axis(cfg)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]

    def heads(t, n, axis):
        t = constrain(t, "dp", None, axis)
        return constrain(t.reshape(b, s, n, dh), "dp", None, axis, None)
    q = heads(q, _nq(cfg), ha)
    k = heads(k, cfg.n_kv_heads, kva)
    v = heads(v, cfg.n_kv_heads, kva)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_for_q(k, v, hq: int, group: int):
    """The kv heads of this rank's ``hq`` q heads, from k/v (B, Hkv, S,
    Dh) whole over 'model': a slice when the rank's q heads take whole
    kv heads (or share one), else one kv head per q head."""
    first = axis_rank(("model",)) * hq
    lo, hi = first // group, (first + hq - 1) // group + 1
    if hq % group == 0 or group % hq == 0:
        return k[:, lo:hi], v[:, lo:hi]
    idx = torch.div(first + torch.arange(hq, device=k.device), group,
                    rounding_mode="floor")
    return k.index_select(1, idx), v.index_select(1, idx)


def _cache_axes(cfg):
    """(head axis, head_dim axis) of the decode cache on the active mesh,
    ``cache_pspecs``' rule: kv heads over 'model' when they divide it,
    else head_dim when that divides it."""
    m = model_axis_size()
    if not m:
        return None, None
    if cfg.n_kv_heads % m == 0:
        return "model", None
    return None, ("model" if cfg.head_dim_ % m == 0 else None)


def _heads_first(t):
    return t.transpose(1, 2)           # (B, S, H, Dh) view -> (B, H, S, Dh)


def _attend(x, p, cfg, positions, window: int):
    """Causal attention over x; returns the output and the roped k, v."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = attention(_heads_first(q), _heads_first(k), _heads_first(v),
                    causal=True, window=window, softcap=cfg.attn_softcap)
    return _heads_first(out).reshape(b, s, -1) @ p["wo"], k, v


def chunked_attention(q, k, v, *, causal: bool, window: int,
                      softcap: float, head_axis=None, q_chunk: int = 1024,
                      kv_chunk: int = 1024):
    """Online-softmax attention, chunked on both sequence axes: the
    reference's ``chunked_attention`` step for step.

    q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh); query positions are
    end-aligned with the keys; ``window <= 0`` disables the sliding
    window.  Scores, softmax statistics and the accumulator are float32;
    k/v repeat to the q heads per chunk (GQA).  Every query chunk scans
    every key chunk, as the reference's ``lax.scan`` does (a chunk fully
    masked for a row adds terms that a later unmasked chunk's rescale
    zeroes).  ``head_axis`` ('model' or None) is the mesh axis the q
    heads shard over, as the reference's constraints name it.  Returns
    (B, Sq, Hq, Dh) in q's dtype.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"chunked_attention: {hq} q heads, {hkv} kv heads")
    group = hq // hkv
    scale = dh ** -0.5
    ha = head_axis
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    pq, pkv = -sq % q_chunk, -skv % kv_chunk
    pad = lambda t, n: F.pad(t, (0, 0, 0, 0, 0, n)) if n else t  # noqa: E731
    qp, kp, vp = pad(q, pq), pad(k, pkv), pad(v, pkv)
    offset = skv - sq                                # end-aligned positions
    ar = lambda n: torch.arange(n, device=q.device)  # noqa: E731
    outs = []
    for qi in range(qp.shape[1] // q_chunk):
        q_c = constrain(qp[:, qi * q_chunk:(qi + 1) * q_chunk], "dp", None,
                        ha, None).float()
        q_pos = qi * q_chunk + ar(q_chunk) + offset
        m = q_c.new_full((b, hq, q_chunk), NEG_INF)
        l_sum = q_c.new_zeros((b, hq, q_chunk))
        acc = q_c.new_zeros((b, hq, q_chunk, dh))
        for ki in range(kp.shape[1] // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_pos = ki * kv_chunk + ar(kv_chunk)
            # per-chunk GQA expansion: with heads sharded each device
            # materializes only its own groups' keys
            kr = constrain(kp[:, sl].repeat_interleave(group, dim=2), "dp",
                           None, ha, None).float()
            vr = constrain(vp[:, sl].repeat_interleave(group, dim=2), "dp",
                           None, ha, None).float()
            s_blk = constrain(torch.einsum("bqhd,bkhd->bhqk", q_c, kr)
                              * scale, "dp", ha, None, None)
            if softcap > 0:
                s_blk = softcap * torch.tanh(s_blk / softcap)
            mask = (k_pos < skv)[None, :]
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s_blk = torch.where(mask, s_blk, NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p_blk = torch.exp(s_blk - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_sum = alpha * l_sum + p_blk.sum(dim=-1)
            acc = constrain(alpha[..., None] * acc + torch.einsum(
                "bhqk,bkhd->bhqd", p_blk, vr), "dp", ha, None, None)
            m = m_new
        safe = torch.where(l_sum == 0.0, 1.0, l_sum)
        outs.append((acc / safe[..., None]).transpose(1, 2))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def attention_block(x, p, cfg, positions, *, window: int):
    """The attention sublayer for training (no cache): the plain chunked
    form, differentiable on any device.

    Under a mesh the chunked attention runs on each rank's own rows and
    q heads (:func:`repro_torch.distributed.constrain.local_map`), the
    layout the reference's constraints name: batch over the data axes,
    q heads over 'model' when they divide it -- its chunk loop never
    goes through DTensor's dispatch.  When the kv heads divide 'model'
    too, each rank takes its own groups' k/v and repeats them per chunk
    as the plain path does; otherwise k/v are repeated to the q heads
    first, over the whole sequence."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    ha = _head_axis(cfg)
    kv_axes = ("dp", None, None, None)
    if ha is not None and cfg.n_kv_heads % model_axis_size() == 0:
        kv_axes = ("dp", None, ha, None)
    elif ha is not None and is_dtensor(k):
        group = q.shape[2] // k.shape[2]
        expand = local_map(lambda t: t.repeat_interleave(group, dim=2),
                           layout(*kv_axes), (layout(*kv_axes),))
        k, v = expand(k), expand(v)
        kv_axes = ("dp", None, ha, None)
    qo = layout("dp", None, ha, None)
    core = local_map(lambda q, k, v: chunked_attention(
        q, k, v, causal=True, window=window, softcap=cfg.attn_softcap,
        head_axis=ha), qo, (qo, layout(*kv_axes), layout(*kv_axes)))
    # laid out as the heads were, so the output projection's gradient
    # comes back in whole heads before the reshape's backward
    return constrain(core(q, k, v).reshape(b, s, -1), "dp", None, ha) \
        @ p["wo"]


def attention_prefill(x, p, cfg, positions, *, window: int, cache_len: int):
    """Causal attention over the prompt; returns the output and the KV
    cache ``(B, Hkv, cache_len, Dh)`` holding the prompt's keys/values
    (under a mesh laid out as ``cache_pspecs`` says)."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} must cover the prompt "
                         f"({s} tokens)")
    if active_mesh() is not None and is_dtensor(x):
        return _prefill_mesh(x, p, cfg, positions, window, cache_len)
    out, k, v = _attend(x, p, cfg, positions, window)
    shape = (b, cfg.n_kv_heads, cache_len, cfg.head_dim_)
    k_cache = k.new_zeros(shape)
    v_cache = v.new_zeros(shape)
    k_cache[:, :, :s] = _heads_first(k)
    v_cache[:, :, :s] = _heads_first(v)
    return out, (k_cache, v_cache)


def _prefill_mesh(x, p, cfg, positions, window, cache_len):
    """:func:`attention_prefill` on each rank's (batch shard, q-head
    shard), the cache built on each rank's shard of its layout."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    ha, kva = _head_axis(cfg), _kv_axis(cfg)
    group = _nq(cfg) // cfg.n_kv_heads
    select = ha is not None and kva is None

    def attend(q, k, v):
        q, k, v = _heads_first(q), _heads_first(k), _heads_first(v)
        if select:
            k, v = _kv_for_q(k, v, q.shape[1], group)
        return _heads_first(attention(q, k, v, causal=True, window=window,
                                      softcap=cfg.attn_softcap))
    qo, kvo = layout("dp", None, ha, None), layout("dp", None, kva, None)
    out = local_map(attend, qo, (qo, kvo, kvo))(q, k, v)

    hk, dhk = _cache_axes(cfg)
    rows, seq = ("dp", None) if not batch_replicated() else (None,
                                                             data_axes())
    n_seq = axes_size(seq or ())
    if cache_len % n_seq:
        raise ValueError(f"a sequence-sharded cache of {cache_len} "
                         f"positions over {n_seq} data ranks")
    span = cache_len // n_seq

    def cache_of(t):                      # t (B, S, Hkv, Dh), local
        off = axis_rank(seq or ()) * span
        c = t.new_zeros((t.shape[0], t.shape[2], span, t.shape[3]))
        hi = min(off + span, s)
        if hi > off:
            c[:, :, :hi - off] = _heads_first(t[:, off:hi])
        return c
    make = local_map(cache_of, layout(rows, hk, seq, dhk),
                     (layout(rows, None, hk, dhk),))
    return row_parallel(out.reshape(b, s, -1), p["wo"]), (make(k), make(v))


def attention_decode(x, p, cfg, cache, cur_len: int, *, window: int):
    """One token per sequence against the cache.

    x (B, 1, D); cache (k, v) each (B, Hkv, Smax, Dh), updated in place
    at ``cur_len``; returns (out, cache).  The kernel reads only the live
    slice: keys ``[0, cur_len]``, or for a window layer the trailing
    ``window`` of them -- what the reference's masked softmax over the
    whole cache keeps.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), cur_len, dtype=torch.int64,
                           device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    k_cache, v_cache = cache
    if active_mesh() is not None and is_dtensor(k_cache):
        out = _decode_mesh(q, k_new, v_new, k_cache, v_cache, cfg, cur_len,
                           window)
        return row_parallel(out.to(x.dtype), p["wo"]), (k_cache, v_cache)
    k_cache[:, :, cur_len] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, cur_len] = v_new[:, 0].to(v_cache.dtype)
    start = max(0, cur_len - window + 1) if window > 0 else 0
    k_att = k_cache[:, :, start:cur_len + 1]
    v_att = v_cache[:, :, start:cur_len + 1]
    if k_att.dtype != q.dtype:   # a cache kept in another dtype
        k_att, v_att = k_att.to(q.dtype), v_att.to(q.dtype)
    out = attention(_heads_first(q), k_att, v_att, causal=True,
                    window=window, softcap=cfg.attn_softcap)
    out = out.reshape(b, 1, -1).to(x.dtype) @ p["wo"]
    return out, (k_cache, v_cache)


def _decode_mesh(q, k_new, v_new, k_cache, v_cache, cfg, cur_len, window):
    """:func:`attention_decode`'s write and attention on each rank's
    shards of the cache, in the layout the cache itself has.  Returns
    the attention output (B, 1, Hq * Dh) in q's dtype."""
    from torch.distributed import _functional_collectives as funcol

    mesh = k_cache.device_mesh
    names = mesh.mesh_dim_names
    cl = list(k_cache.placements)

    def on(d):
        return tuple(n for n, pl in zip(names, cl) if pl.is_shard(d))
    rows, hk, seq, dhk = (on(d) or None for d in range(4))
    seq = seq or ()
    kin = layout(rows, None, hk, dhk)

    def write(kc, vc, kn, vn):       # the new key/value on its shard
        off = axis_rank(seq) * kc.shape[2]
        if off <= cur_len < off + kc.shape[2]:
            kc[:, :, cur_len - off] = kn[:, 0].to(kc.dtype)
            vc[:, :, cur_len - off] = vn[:, 0].to(vc.dtype)
        return kc, vc
    local_map(write, (cl, cl), (cl, cl, kin, kin))(k_cache, v_cache,
                                                   k_new, v_new)

    ha = _head_axis(cfg)
    group = _nq(cfg) // cfg.n_kv_heads
    select = ha is not None and hk is None
    start = max(0, cur_len - window + 1) if window > 0 else 0
    model = (mesh, names.index("model")) if dhk else None
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    softcap = cfg.attn_softcap

    def live(q, kc, vc):
        """This rank's live keys (whole head_dim, its q heads' kv
        heads), or None when its sequence slice holds none."""
        off = axis_rank(seq) * kc.shape[2]
        lo, hi = max(start, off), min(cur_len + 1, off + kc.shape[2])
        if hi <= lo:
            return None
        k, v = kc[:, :, lo - off:hi - off], vc[:, :, lo - off:hi - off]
        if model is not None:        # head_dim-sharded: gather the slice
            k = gather(k.contiguous(), 3, model)
            v = gather(v.contiguous(), 3, model)
        if select:
            k, v = _kv_for_q(k, v, q.shape[1], group)
        if k.dtype != q.dtype:
            k, v = k.to(q.dtype), v.to(q.dtype)
        return k, v

    def attend(q, kc, vc):           # q (B, 1, Hq, Dh), local
        q = _heads_first(q)
        k, v = live(q, kc, vc)
        out = attention(q, k, v, causal=True, window=window,
                        softcap=softcap)
        return out.reshape(q.shape[0], 1, -1)

    def attend_part(q, kc, vc):      # a slice of the sequence, merged
        q = _heads_first(q)
        kv = live(q, kc, vc)
        if kv is None:
            out = q.new_zeros(q.shape, dtype=torch.float32)
            lse = q.new_full(q.shape[:3], float("-inf"),
                             dtype=torch.float32)
        else:
            out, lse = attention(q, *kv, causal=True, window=window,
                                 softcap=softcap, return_lse=True)
            out = out.float()
        top = lse
        for n in seq:
            top = funcol.all_reduce(top, "max", (mesh, names.index(n)))
        w = torch.exp(lse - top)[..., None]             # (B, Hq, 1, 1)
        num = torch.cat([out * w, w], dim=-1)
        for n in seq:
            num = funcol.all_reduce(num, "sum", (mesh, names.index(n)))
        out = (num[..., :-1] / num[..., -1:]).to(q.dtype)
        return out.reshape(q.shape[0], 1, -1)

    qo = layout(rows, None, ha, None)
    return local_map(attend_part if seq else attend, layout(rows, None, ha),
                     (qo, cl, cl))(q, k_cache, v_cache)
