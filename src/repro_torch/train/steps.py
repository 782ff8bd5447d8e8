"""Train / prefill / decode step builders.

Mirrors ``repro/train/steps.py``.  ``make_train_step`` supports
gradient-accumulation microbatching: microbatch ``i`` is the
reference's ``x.reshape((grad_accum, -1) + x.shape[1:])[i]``, its
gradients accumulate in float32, and the loss and gradients are
averaged over the microbatches, so live activation memory scales with
the microbatch while the arithmetic stays the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         decay_mask, tree_leaves)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_accum: int = 1, remat: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; ``batch`` holds ``tokens`` and ``labels``
    tensors on the parameters' device (and a VLM's ``img_embeds``).  The step updates ``params`` and
    ``opt_state`` in place and returns them, with ``metrics`` ``loss``,
    ``grad_norm`` and ``lr`` (0-dim float32 tensors)."""
    decay = None

    def value_and_grad(params, leaves, batch):
        loss = lm.loss_fn(params, batch, cfg, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        nonlocal decay
        leaves = tree_leaves(params)
        if decay is None:
            decay = decay_mask(cfg, params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                if grad_accum == 1:
                    loss, grads = value_and_grad(params, leaves, batch)
                else:
                    micro = lambda x, i: x.reshape(  # noqa: E731
                        (grad_accum, -1) + tuple(x.shape[1:]))[i]
                    tot = torch.zeros((), dtype=torch.float32,
                                      device=leaves[0].device)
                    grads = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in leaves]
                    for i in range(grad_accum):
                        l_i, g_i = value_and_grad(params, leaves, {
                            k: micro(v, i) for k, v in batch.items()})
                        tot = tot + l_i
                        grads = [a + g.float() for a, g in zip(grads, g_i)]
                        del g_i
                    loss = tot / grad_accum
                    grads = [g / grad_accum for g in grads]
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        params, opt_state, metrics = adamw_update(params, list(grads),
                                                  opt_state, opt_cfg, decay)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens, img_embeds=None):
        return lm.prefill(params, tokens, cfg, max_len=max_len,
                          img_embeds=img_embeds)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, cache, cur_len):
        return lm.decode_step(params, tokens, cache, cur_len, cfg)
    return decode_step
