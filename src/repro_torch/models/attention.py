"""Attention layers: the chunked training form, prefill (cache
construction) and cached decode.

Mirrors ``repro/models/attention.py``, its sharding constraints
included: under a mesh (:func:`repro_torch.distributed.constrain.use_mesh`)
with DTensor inputs, q and the per-chunk GQA expansion of k/v are
sharded over 'model' on the flat q-head axis when the (padded) head
count divides it, k/v leave the projection replicated over 'model'
(the training form then takes each rank's kv heads), and every
activation is batch-sharded over the data axes; on plain tensors the
constraints return their input.  :func:`attention_block`, the training
form, is the reference's chunked online softmax in plain PyTorch
(:func:`chunked_attention`), so autograd differentiates it on any
device; the attention kernel has no backward.  Prefill and decode go
through :func:`repro_torch.kernels.flash_attention.ops.attention`, decode
with Sq = 1 on the live slice of the cache.

The KV cache is stored ``(B, Hkv, Smax, Dh)`` (the reference's is
``(B, Smax, Hkv, Dh)``) so that slice is a strided view, and decode
writes each new key and value into it in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.constrain import (constrain, is_dtensor, layout,
                                               local_map, model_axis_size)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import init_normal, rope

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


def _project_qkv(x, p, cfg, positions):
    """(B, S, D) -> q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh), roped."""
    b, s, _ = x.shape
    dh = cfg.head_dim_
    ha = _head_axis(cfg)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(q.reshape(b, s, _nq(cfg), dh), "dp", None, ha, None)
    # k/v stay GQA-compressed and replicated over 'model' (small)
    k = constrain(k.reshape(b, s, cfg.n_kv_heads, dh), "dp", None, None, None)
    v = constrain(v.reshape(b, s, cfg.n_kv_heads, dh), "dp", None, None, None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


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
    return core(q, k, v).reshape(b, s, -1) @ p["wo"]


def attention_prefill(x, p, cfg, positions, *, window: int, cache_len: int):
    """Causal attention over the prompt; returns the output and the KV
    cache ``(B, Hkv, cache_len, Dh)`` holding the prompt's keys/values."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} must cover the prompt "
                         f"({s} tokens)")
    out, k, v = _attend(x, p, cfg, positions, window)
    shape = (b, cfg.n_kv_heads, cache_len, cfg.head_dim_)
    k_cache = k.new_zeros(shape)
    v_cache = v.new_zeros(shape)
    k_cache[:, :, :s] = _heads_first(k)
    v_cache[:, :, :s] = _heads_first(v)
    return out, (k_cache, v_cache)


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
