"""Train / prefill / decode step builders.

Mirrors ``repro/train/steps.py``.  ``make_train_step`` supports
gradient-accumulation microbatching: microbatch ``i`` is the
reference's ``x.reshape((grad_accum, -1) + x.shape[1:])[i]``, its
gradients accumulate in float32, and the loss and gradients are
averaged over the microbatches, so live activation memory scales with
the microbatch while the arithmetic stays the reference's.

The same step runs over a mesh when the parameters are DTensors
(placed by ``param_pspecs``, the moments by ``zero1_pspecs`` through
``init_opt_state(params, specs)``) and the batch is a DTensor sharded by
``batch_pspec``: the step then runs under the mesh
(:func:`repro_torch.distributed.constrain.use_mesh`, so the models'
constraints act) and with DTensor's implicit replication, so the plain
host-side tensors the models and AdamW make (positions, masks, the
schedule's scalars) count as replicated.  A microbatch's rows span data
ranks (on 16 of them, microbatch i of 8 is held by two), so the batch is
gathered once a step and each microbatch laid out over the data axes
again after it is cut: it holds the reference's rows.  A microbatch the
data axes do not divide is replicated over them
(:func:`repro_torch.distributed.constrain.batch_rows`).  The metrics
come back as plain tensors on every rank.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.constrain import (batch_rows, constrain, full,
                                               is_dtensor, use_mesh)
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

    def micro(x, i):
        x = x.reshape((grad_accum, -1) + tuple(x.shape[1:]))[i]
        return constrain(x, "dp", *(None,) * (x.dim() - 1))

    def whole(x):     # a microbatch's rows span data ranks: gather first
        return constrain(x, *(None,) * x.dim())

    def train_step(params, opt_state, batch):
        nonlocal decay
        leaves = tree_leaves(params)
        if decay is None:
            decay = decay_mask(cfg, params)
        rows = next(iter(batch.values())).shape[0] // grad_accum
        with _on_mesh(leaves[0]), batch_rows(rows), torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                if grad_accum == 1:
                    loss, grads = value_and_grad(params, leaves, batch)
                else:
                    tot = torch.zeros((), dtype=torch.float32,
                                      device=leaves[0].device)
                    batch = {k: whole(v) for k, v in batch.items()}
                    for i in range(grad_accum):
                        l_i, g_i = value_and_grad(params, leaves, {
                            k: micro(v, i) for k, v in batch.items()})
                        tot = tot + l_i
                        # float32 sums from the first microbatch's (0 + g
                        # is g): a DTensor gradient stays data-partial
                        grads = ([g.float() for g in g_i] if i == 0 else
                                 [a + g.float() for a, g in zip(grads, g_i)])
                        del g_i
                    loss = tot / grad_accum
                    grads = [g / grad_accum for g in grads]
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            params, opt_state, metrics = adamw_update(
                params, list(grads), opt_state, opt_cfg, decay)
        metrics["loss"] = loss
        return params, opt_state, {k: full(v) for k, v in metrics.items()}

    return train_step


def _on_mesh(leaf):
    """The mesh context of a DTensor parameter (its mesh active, plain
    tensors replicated implicitly); nothing for a plain one."""
    if not is_dtensor(leaf):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(use_mesh(leaf.device_mesh))
    stack.enter_context(implicit_replication())
    return stack


def _serving(leaf):
    """The mesh context of a serving step: :func:`_on_mesh`, and for
    DTensor parameters no autograd under ``no_grad`` rather than inference
    mode.  Under inference mode DTensor's sharding propagation takes other
    strategies (a batch replicated over 'data' gets its sequence sharded
    over it), and it breaks ties between strategies of equal cost in set
    order, which differs between processes: ranks then issued different
    collectives and hung (seen on four ``gloo`` ranks at 4 x 1)."""
    stack = contextlib.ExitStack()
    stack.enter_context(_on_mesh(leaf))
    if is_dtensor(leaf):
        stack.enter_context(torch.inference_mode(False))
        stack.enter_context(torch.no_grad())
    return stack


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """Returns ``prefill_step(params, tokens, img_embeds=None) ->
    (logits, cache)``; with DTensor parameters it runs under their mesh,
    as the train step does."""
    def prefill_step(params, tokens, img_embeds=None):
        with _serving(tree_leaves(params)[0]):
            return lm.prefill(params, tokens, cfg, max_len=max_len,
                              img_embeds=img_embeds)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """Returns ``decode_step(params, tokens, cache, cur_len) -> (logits,
    cache)``; with DTensor parameters it runs under their mesh."""
    def decode_step(params, tokens, cache, cur_len):
        with _serving(tree_leaves(params)[0]):
            return lm.decode_step(params, tokens, cache, cur_len, cfg)
    return decode_step
