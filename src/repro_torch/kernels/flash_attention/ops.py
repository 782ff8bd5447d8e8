"""Attention dispatched by device.

Every attention layer of the port (prefill and cached decode) goes
through :func:`attention`.  A CUDA tensor launches the hand-written
kernel (``csrc/flash_attention.cu``); a CPU tensor takes the plain
materialized version.  The reference's layers call a chunked jnp form
(``repro/models/attention.py::chunked_attention``) with the same
semantics; the Pallas kernel is its TPU drop-in.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float = 0.0, return_lse: bool = False):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype.  Strided views are taken as they are (the last axis must be
    contiguous on the card); ``window`` None or <= 0 disables the
    sliding window.  ``return_lse`` also returns each row's float32
    log-sum-exp (B, Hq, Sq) (``-inf`` for a row with no key); on the
    card the bf16 decode form (Sq = 1) and the float32 form give it, the
    bf16 prefill form raises."""
    window = window if window is not None and window > 0 else None
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap, return_lse=return_lse)
        if return_lse:
            return out[0].to(q.dtype), out[1]
        return out.to(q.dtype)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, return_lse=return_lse)
