"""Attention layers: the chunked training form, prefill (cache
construction) and cached decode.

Mirrors ``repro/models/attention.py`` without its mesh constraints (one
card has no ``model`` axis).  :func:`attention_block`, the training
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


def _project_qkv(x, p, cfg, positions):
    """(B, S, D) -> q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh), roped."""
    b, s, _ = x.shape
    dh = cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, s, _nq(cfg), dh), positions, cfg.rope_theta)
    k = rope(k.reshape(b, s, cfg.n_kv_heads, dh), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, dh)


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
                      softcap: float, q_chunk: int = 1024,
                      kv_chunk: int = 1024):
    """Online-softmax attention, chunked on both sequence axes: the
    reference's ``chunked_attention`` step for step.

    q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh); query positions are
    end-aligned with the keys; ``window <= 0`` disables the sliding
    window.  Scores, softmax statistics and the accumulator are float32;
    k/v repeat to the q heads per chunk (GQA).  Every query chunk scans
    every key chunk, as the reference's ``lax.scan`` does (a chunk fully
    masked for a row adds terms that a later unmasked chunk's rescale
    zeroes).  Returns (B, Sq, Hq, Dh) in q's dtype.
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"chunked_attention: {hq} q heads, {hkv} kv heads")
    group = hq // hkv
    scale = dh ** -0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    pq, pkv = -sq % q_chunk, -skv % kv_chunk
    pad = lambda t, n: F.pad(t, (0, 0, 0, 0, 0, n)) if n else t  # noqa: E731
    qp, kp, vp = pad(q, pq), pad(k, pkv), pad(v, pkv)
    offset = skv - sq                                # end-aligned positions
    ar = lambda n: torch.arange(n, device=q.device)  # noqa: E731
    outs = []
    for qi in range(qp.shape[1] // q_chunk):
        q_c = qp[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_pos = qi * q_chunk + ar(q_chunk) + offset
        m = q_c.new_full((b, hq, q_chunk), NEG_INF)
        l_sum = q_c.new_zeros((b, hq, q_chunk))
        acc = q_c.new_zeros((b, hq, q_chunk, dh))
        for ki in range(kp.shape[1] // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            k_pos = ki * kv_chunk + ar(kv_chunk)
            kr = kp[:, sl].repeat_interleave(group, dim=2).float()
            vr = vp[:, sl].repeat_interleave(group, dim=2).float()
            s_blk = torch.einsum("bqhd,bkhd->bhqk", q_c, kr) * scale
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
            acc = alpha[..., None] * acc + torch.einsum(
                "bhqk,bkhd->bhqd", p_blk, vr)
            m = m_new
        safe = torch.where(l_sum == 0.0, 1.0, l_sum)
        outs.append((acc / safe[..., None]).transpose(1, 2))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def attention_block(x, p, cfg, positions, *, window: int):
    """The attention sublayer for training (no cache): the plain chunked
    form, differentiable on any device."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = chunked_attention(q, k, v, causal=True, window=window,
                            softcap=cfg.attn_softcap)
    return out.reshape(b, s, -1) @ p["wo"]


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
