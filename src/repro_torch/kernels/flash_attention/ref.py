"""Plain PyTorch attention: the materialized form of the reference's
``repro/kernels/flash_attention/ref.py::mha_ref``.

GQA by repeating k/v heads, scores and softmax in float32, end-aligned
causal mask, optional sliding window and Gemma-2 softcap.  A row whose
every key is masked outputs 0 (its softmax normalizer is 0), the
contract the kernel keeps; ``mha_ref`` itself returns the mean of v
there (ROADMAP Queue 3).  With ``return_lse`` it also gives each row's
log-sum-exp of its (scaled, softcapped) logits, ``-inf`` for a row with
no key: what a sequence-sharded decode merges its ranks' partial
softmaxes by.
"""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float = 0.0, scale: float | None = None,
                  return_lse: bool = False):
    """Materialized attention.

    Args:
        q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
        causal: query i attends to keys j <= i + (Skv - Sq).
        window: also mask keys j <= i + (Skv - Sq) - window.
        softcap: if > 0, logits = softcap * tanh(logits / softcap).
        scale: defaults to D ** -0.5.

    Returns (B, Hq, Sq, D) float32, and with ``return_lse`` the rows'
    log-sum-exp (B, Hq, Sq) float32.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kj = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr)
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    if not return_lse:
        return out
    return out, (m + torch.log(l))[..., 0]
