"""The decoder-only LM: dense (gemma2), hybrid (recurrentgemma) and SSM
(falcon-mamba) stacks, for training and serving.

Mirrors ``repro/models/lm.py``.  The reference scans
``layer_pattern * n_rep`` with stacked parameters and unrolls the tail;
the port keeps one flat list of layers in the same order, layer
``r * len(pattern) + i`` being the reference's ``stack[i][..][r]`` and
the tail after them.  Parameters are plain dicts of tensors, the
reference's names; the cache is a list with one dict per layer.

Entry points:
    init_params                        parameters (shapes and init
                                       formulas of the reference, drawn
                                       from a torch.Generator)
    forward_train                      full-sequence activations through
                                       the plain training forms (autograd)
    loss_fn                            sequence-chunked cross-entropy (never
                                       materializes the full (B, S, V)
                                       logits)
    prefill                            prompt -> last logits + cache
    decode_step                        one cached token per sequence

Not ported yet (ROADMAP Queue 1 #12b): MoE layers, multi-codebook audio
and image-prefix embeddings.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import rglru as rgl
from repro_torch.models.config import (ATTN, ATTN_LOCAL, MAMBA, MOE,
                                       RECURRENT, ModelConfig)
from repro_torch.models.layers import apply_norm, dtype_of, init_normal, mlp


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 #12b: MoE and the "
        "other architectures)")


def _check_config(cfg: ModelConfig):
    if MOE in cfg.layer_types():
        raise _unported("the MoE layer")
    if cfg.num_codebooks:
        raise _unported("multi-codebook embedding")
    if cfg.img_tokens:
        raise _unported("the image-prefix embedding")


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def _init_norm(cfg, device, dtype):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def _init_mlp(cfg, gen, device, dtype):
    d, f = cfg.d_model, cfg.d_ff
    normal = init_normal(gen, device, dtype)

    p = {"up": normal((d, f), d ** -0.5), "down": normal((f, d), f ** -0.5)}
    if cfg.mlp_gated:
        p["gate"] = normal((d, f), d ** -0.5)
    return p


def init_layer(cfg: ModelConfig, kind: str, gen, device, dtype):
    norm = lambda: _init_norm(cfg, device, dtype)      # noqa: E731
    if kind in (ATTN, ATTN_LOCAL):
        p = {"norm1": norm(),
             "attn": attn.init_attention(cfg, gen, device, dtype),
             "norm2": norm(), "mlp": _init_mlp(cfg, gen, device, dtype)}
    elif kind == MAMBA:
        p = {"norm1": norm(), "mamba": mam.init_mamba(cfg, gen, device, dtype)}
    elif kind == RECURRENT:
        p = {"norm1": norm(),
             "rec": rgl.init_recurrent(cfg, gen, device, dtype),
             "norm2": norm(), "mlp": _init_mlp(cfg, gen, device, dtype)}
    else:
        raise _unported(f"layer kind {kind!r}")
    if cfg.use_post_norm:
        p["post_norm1"] = norm()
        p["post_norm2"] = norm()
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the reference's shapes, dtypes and init
    formulas, drawn from ``gen`` (a generator on ``device``)."""
    _check_config(cfg)
    dt = dtype_of(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    normal = init_normal(gen, device, dt)
    params = {"embed": normal((v, d), d ** -0.5),
              "layers": [init_layer(cfg, kind, gen, device, dt)
                         for kind in cfg.layer_types()],
              "final_norm": _init_norm(cfg, device, dt)}
    if not cfg.tie_embeddings:
        params["head"] = normal((d, v), d ** -0.5)
    return params


def to_device(tree, device):
    """A parameter tree or cache (dicts, lists, tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# --------------------------------------------------------------------- #
# embedding / head
# --------------------------------------------------------------------- #
def embed_tokens(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.scale_embeddings:   # the scale rounded to x's dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def logits_for(params, x, cfg: ModelConfig):
    """Float32 logits for a (B, S', D) activation slice."""
    h = params["embed"].T if cfg.tie_embeddings else params["head"]
    out = (x @ h).float()
    if cfg.final_softcap > 0:
        out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
    return out


# --------------------------------------------------------------------- #
# training: stack, forward, loss
# --------------------------------------------------------------------- #
def _apply_layer(x, p, cfg: ModelConfig, kind: str, positions):
    """A layer's training form (no cache)."""
    if kind in (ATTN, ATTN_LOCAL):
        return _attention_layer(x, p, cfg, lambda y: (attn.attention_block(
            y, p["attn"], cfg, positions, window=_window(cfg, kind)), None))[0]
    if kind == MAMBA:
        return x + mam.mamba_block(apply_norm(x, p["norm1"], cfg),
                                   p["mamba"], cfg)
    x = x + rgl.recurrent_block(apply_norm(x, p["norm1"], cfg), p["rec"], cfg)
    return x + mlp(apply_norm(x, p["norm2"], cfg), p["mlp"], cfg)


def run_stack(x, params, cfg: ModelConfig, positions, remat: bool = True):
    """Apply every layer (training forms).  Returns (x, aux); aux, the MoE
    balance loss of the reference, is 0 (no MoE layer is ported).

    The repeated layers run in super-blocks of ``len(layer_pattern)``
    consecutive layers, the reference's scan body; with ``remat`` each
    super-block is checkpointed (its activations recomputed in the
    backward pass), as the reference's ``jax.checkpoint`` of the body.
    The tail is unrolled, never rematerialized.
    """
    kinds = cfg.layer_types()
    n_pat = len(cfg.layer_pattern)
    n_stack = cfg.n_rep * n_pat

    def superblock(x, first):
        for j in range(first, first + n_pat):
            x = _apply_layer(x, params["layers"][j], cfg, kinds[j],
                             positions)
        return x

    for first in range(0, n_stack, n_pat):
        x = (checkpoint(superblock, x, first, use_reentrant=False) if remat
             else superblock(x, first))
    for j in range(n_stack, cfg.n_layers):
        x = _apply_layer(x, params["layers"][j], cfg, kinds[j], positions)
    return x, x.new_zeros((), dtype=torch.float32)


def forward_train(params, tokens, cfg: ModelConfig, remat: bool = True):
    """Full-sequence activations before the head, tokens (B, S) ->
    (x (B, S, D), aux)."""
    _check_config(cfg)
    x = embed_tokens(params, tokens, cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux = run_stack(x, params, cfg, positions, remat=remat)
    return apply_norm(x, params["final_norm"], cfg), aux


def _chunk_nll(params, xi, yi, cfg):
    """Summed negative log-likelihood of one sequence chunk, and its
    count of valid (label >= 0) positions."""
    lg = logits_for(params, xi, cfg)                       # (B, C, V) f32
    lse = torch.logsumexp(lg, dim=-1)
    valid = yi >= 0
    tgt = torch.gather(lg, -1, torch.clamp_min(yi, 0)[..., None])[..., 0]
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def loss_fn(params, batch, cfg: ModelConfig, seq_chunk: int = 512,
            remat: bool = True):
    """Mean next-token cross-entropy + 0.01 aux, the reference's.

    ``batch`` holds ``tokens`` and ``labels`` (B, S) int tensors.  The
    shifted sequence runs in chunks of ``seq_chunk`` positions (labels
    padded with -1), each chunk's float32 logits made, reduced and, with
    ``remat``, recomputed in the backward pass, so at most one chunk's
    (B, C, V) logits is alive; the per-chunk sums accumulate in order.
    """
    tokens, labels = batch["tokens"], batch["labels"]
    x, aux = forward_train(params, tokens, cfg, remat=remat)
    x, y = x[:, :-1], labels[:, 1:]
    b, s = x.shape[:2]
    seq_chunk = min(seq_chunk, s)
    pad = -s % seq_chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        y = torch.nn.functional.pad(y, (0, pad), value=-1)
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, s + pad, seq_chunk):
        xi, yi = x[:, c0:c0 + seq_chunk], y[:, c0:c0 + seq_chunk]
        nll, n = (checkpoint(_chunk_nll, params, xi, yi, cfg,
                             use_reentrant=False) if remat
                  else _chunk_nll(params, xi, yi, cfg))
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp_min(cnt, 1) + 0.01 * aux


# --------------------------------------------------------------------- #
# serving: cache / prefill / decode
# --------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=torch.bfloat16) -> list:
    """Zeroed decode state, one dict per layer: attention ``k``/``v``
    (B, Hkv, max_len, Dh) in ``dtype``; float32 recurrent and SSM
    states."""
    _check_config(cfg)
    cache = []
    for kind in cfg.layer_types():
        if kind in (ATTN, ATTN_LOCAL):
            shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)})
        elif kind == MAMBA:
            cache.append(mam.init_mamba_state(cfg, batch, device))
        else:
            cache.append(rgl.init_recurrent_state(cfg, batch, device))
    return cache


def _attention_layer(x, p, cfg, run):
    """Norm, attention (``run`` -> (h, cache)), post-norm, residual, then
    the MLP sublayer likewise."""
    h, cache = run(apply_norm(x, p["norm1"], cfg))
    if cfg.use_post_norm:
        h = apply_norm(h, p["post_norm1"], cfg)
    x = x + h
    h = mlp(apply_norm(x, p["norm2"], cfg), p["mlp"], cfg)
    if cfg.use_post_norm:
        h = apply_norm(h, p["post_norm2"], cfg)
    return x + h, cache


def _window(cfg, kind):
    return cfg.window_size if kind == ATTN_LOCAL else 0


def _prefill_layer(x, p, cfg, kind, positions, max_len):
    if kind in (ATTN, ATTN_LOCAL):
        def run(y):
            h, (k, v) = attn.attention_prefill(
                y, p["attn"], cfg, positions, window=_window(cfg, kind),
                cache_len=max_len)
            return h, {"k": k, "v": v}
        return _attention_layer(x, p, cfg, run)
    if kind == MAMBA:
        h, st = mam.mamba_prefill(apply_norm(x, p["norm1"], cfg), p["mamba"],
                                  cfg)
        return x + h, st
    h, st = rgl.recurrent_prefill(apply_norm(x, p["norm1"], cfg), p["rec"],
                                   cfg)
    x = x + h
    return x + mlp(apply_norm(x, p["norm2"], cfg), p["mlp"], cfg), st


def prefill(params, tokens, cfg: ModelConfig, max_len: int):
    """Process the prompt (B, S); returns (last-token logits (B, 1, V),
    cache), attention caches sized ``max_len``."""
    _check_config(cfg)
    x = embed_tokens(params, tokens, cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = []
    for kind, p in zip(cfg.layer_types(), params["layers"]):
        x, c = _prefill_layer(x, p, cfg, kind, positions, max_len)
        cache.append(c)
    x = apply_norm(x, params["final_norm"], cfg)
    return logits_for(params, x[:, -1:], cfg), cache


def _decode_layer(x, p, cfg, kind, cache, cur_len):
    if kind in (ATTN, ATTN_LOCAL):
        def run(y):
            h, (k, v) = attn.attention_decode(
                y, p["attn"], cfg, (cache["k"], cache["v"]), cur_len,
                window=_window(cfg, kind))
            return h, {"k": k, "v": v}
        return _attention_layer(x, p, cfg, run)
    if kind == MAMBA:
        h, st = mam.mamba_decode(apply_norm(x, p["norm1"], cfg), p["mamba"],
                                 cfg, cache)
        return x + h, st
    h, st = rgl.recurrent_decode(apply_norm(x, p["norm1"], cfg), p["rec"],
                                 cfg, cache)
    x = x + h
    return x + mlp(apply_norm(x, p["norm2"], cfg), p["mlp"], cfg), st


def decode_step(params, tokens, cache: list, cur_len: int,
                cfg: ModelConfig):
    """One new token per sequence: tokens (B, 1) at position ``cur_len``
    (a host int).  Returns (logits (B, 1, V), cache); attention caches
    are updated in place, recurrent states replaced."""
    x = embed_tokens(params, tokens, cfg)
    new_cache = []
    for kind, p, c in zip(cfg.layer_types(), params["layers"], cache):
        x, nc = _decode_layer(x, p, cfg, kind, c, cur_len)
        new_cache.append(nc)
    x = apply_norm(x, params["final_norm"], cfg)
    return logits_for(params, x, cfg), new_cache
