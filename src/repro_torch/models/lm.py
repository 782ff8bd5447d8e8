"""The decoder-only LM of every assigned family: dense (gemma2, stablelm,
starcoder2, qwen1.5), MoE (olmoe, qwen2-moe), hybrid (recurrentgemma),
SSM (falcon-mamba), audio over four codebooks (musicgen) and an
image-prefix VLM (llava-next), for training and serving.

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
    abstract_params                    the same tree on the meta device
                                       (shapes and dtypes, no memory)
    forward_train                      full-sequence activations through
                                       the plain training forms (autograd)
    loss_fn                            sequence-chunked cross-entropy (never
                                       materializes the full (B, S, V)
                                       logits) + 0.01 x the MoE aux loss
    prefill                            prompt -> last logits + cache
    decode_step                        one cached token per sequence

A codebook model (``num_codebooks`` K) takes tokens (B, S, K) and gives
logits (B, S, K, V); a VLM takes ``img_embeds`` (B, img_tokens, D),
prepended to the text.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.constrain import (batch_rows, constrain, layout,
                                               local_map, model_axis_size)
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rgl
from repro_torch.models.config import (ATTN, ATTN_LOCAL, MAMBA, MOE,
                                       RECURRENT, ModelConfig)
from repro_torch.models.layers import (apply_norm, dtype_of, init_mlp,
                                       init_norm, init_normal, mlp)

ATTENTION_KINDS = (ATTN, ATTN_LOCAL, MOE)


# --------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------- #
def init_layer(cfg: ModelConfig, kind: str, gen, device, dtype):
    norm = lambda: init_norm(cfg, device, dtype)       # noqa: E731
    if kind in ATTENTION_KINDS:
        p = {"norm1": norm(),
             "attn": attn.init_attention(cfg, gen, device, dtype),
             "norm2": norm()}
        if kind == MOE:
            p["moe"] = moe_mod.init_moe(cfg, gen, device, dtype)
        else:
            p["mlp"] = init_mlp(cfg, gen, device, dtype)
    elif kind == MAMBA:
        p = {"norm1": norm(), "mamba": mam.init_mamba(cfg, gen, device, dtype)}
    elif kind == RECURRENT:
        p = {"norm1": norm(),
             "rec": rgl.init_recurrent(cfg, gen, device, dtype),
             "norm2": norm(), "mlp": init_mlp(cfg, gen, device, dtype)}
    else:
        raise ValueError(kind)
    if cfg.use_post_norm:
        p["post_norm1"] = norm()
        p["post_norm2"] = norm()
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Random parameters with the reference's shapes, dtypes and init
    formulas, drawn from ``gen`` (a generator on ``device``)."""
    dt = dtype_of(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    cb = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    normal = init_normal(gen, device, dt)
    params = {"embed": normal(cb + (v, d), d ** -0.5),
              "layers": [init_layer(cfg, kind, gen, device, dt)
                         for kind in cfg.layer_types()],
              "final_norm": init_norm(cfg, device, dt)}
    if not cfg.tie_embeddings:
        params["head"] = normal(cb + (d, v), d ** -0.5)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """:func:`init_params`'s tree on the ``meta`` device: the shapes and
    dtypes the sharding rules read, at any size, with no storage."""
    return init_params(cfg, None, torch.device("meta"))


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
def _lookup(table, tokens, n_codebooks: int):
    if n_codebooks:
        x = 0
        for k in range(n_codebooks):
            x = x + table[k][tokens[..., k]]
        return x
    return table[tokens]


def embed_tokens(params, tokens, cfg: ModelConfig, img_embeds=None):
    """tokens (B, S), or (B, S, K) for a codebook model (the K codebooks'
    embeddings summed in order, in the weights' dtype); the text scaled,
    then ``img_embeds`` (B, I, D) prepended.  Under a mesh the lookup
    runs on each rank's rows against the whole (gathered) table, whose
    gradient is then a partial sum over the data axes."""
    table = params["embed"]
    tok_axes = ("dp",) + (None,) * (tokens.dim() - 1)
    x = local_map(lambda t, i: _lookup(t, i, cfg.num_codebooks),
                  layout("dp", None, None), (layout(), layout(*tok_axes)),
                  (layout(partial=("dp",)), layout(*tok_axes)))(table, tokens)
    if cfg.scale_embeddings:   # the scale rounded to x's dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    return x


def logits_for(params, x, cfg: ModelConfig):
    """Float32 logits for a (B, S', D) activation slice: (B, S', V), or
    (B, S', K, V) for a codebook model."""
    if cfg.num_codebooks:   # under a mesh on each rank's rows and vocab
        h = (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
             else params["head"])
        m = model_axis_size()
        va = "model" if m and cfg.vocab_size % m == 0 else None
        rows, hv = ("dp", None, None), (None, None, va)
        out = local_map(lambda x, h: torch.einsum("bsd,kdv->bskv", x, h),
                        layout("dp", None, None, va),
                        (layout(*rows), layout(*hv)),
                        (layout(*rows, partial=(va,)),
                         layout(*hv, partial=("dp",))))(x, h)
    else:
        out = x @ (params["embed"].T if cfg.tie_embeddings
                   else params["head"])
    out = out.float()
    if cfg.final_softcap > 0:
        out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
    return out


# --------------------------------------------------------------------- #
# training: stack, forward, loss
# --------------------------------------------------------------------- #
def _apply_layer(x, p, cfg: ModelConfig, kind: str, positions):
    """A layer's training form (no cache).  Returns (x, aux), aux the MoE
    layer's balance loss (None for other layers)."""
    if kind in ATTENTION_KINDS:
        x, _, aux = _attention_layer(x, p, cfg, kind, lambda y: (
            attn.attention_block(y, p["attn"], cfg, positions,
                                 window=_window(cfg, kind)), None))
        return x, aux
    block = mam.mamba_block if kind == MAMBA else rgl.recurrent_block
    return _ssm_layer(x, p, cfg, kind, lambda y, q: (block(y, q, cfg),
                                                     None))[0], None


def _sub(h):
    """A sublayer's output as the residual stream holds it under a mesh:
    rows over the data axes, whole over 'model' (a row-parallel product's
    partial sums reduced here, before a norm or residual takes them)."""
    return constrain(h, "dp", None, None)


def _ssm_layer(x, p, cfg, kind, run):
    """A Mamba layer, or a recurrent layer and its MLP: ``run(y, params)``
    -> (h, state).  Returns (x, state)."""
    name = "mamba" if kind == MAMBA else "rec"
    h, st = run(apply_norm(x, p["norm1"], cfg), p[name])
    x = x + _sub(h)
    if kind == RECURRENT:
        x = x + _sub(mlp(apply_norm(x, p["norm2"], cfg), p["mlp"], cfg))
    return x, st


def run_stack(x, params, cfg: ModelConfig, positions, remat: bool = True):
    """Apply every layer (training forms).  Returns (x, aux), aux the sum
    of the MoE layers' balance losses in layer order (float32 0 without
    one), as the reference carries it through its scan.

    The repeated layers run in super-blocks of ``len(layer_pattern)``
    consecutive layers, the reference's scan body; with ``remat`` each
    super-block is checkpointed (its activations recomputed in the
    backward pass), as the reference's ``jax.checkpoint`` of the body.
    The tail is unrolled, never rematerialized.
    """
    kinds = cfg.layer_types()
    n_pat = len(cfg.layer_pattern)
    n_stack = cfg.n_rep * n_pat

    def layers(x, aux, lo, hi):
        for j in range(lo, hi):
            x, a = _apply_layer(x, params["layers"][j], cfg, kinds[j],
                                positions)
            if a is not None:
                aux = aux + a
        return x, aux

    aux = x.new_zeros((), dtype=torch.float32)
    for first in range(0, n_stack, n_pat):
        x, aux = (checkpoint(layers, x, aux, first, first + n_pat,
                             use_reentrant=False) if remat
                  else layers(x, aux, first, first + n_pat))
    return layers(x, aux, n_stack, cfg.n_layers)


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def forward_train(params, tokens, cfg: ModelConfig, img_embeds=None,
                  remat: bool = True):
    """Full-sequence activations before the head (image positions
    first), tokens (B, S[, K]) -> (x (B, I + S, D), aux)."""
    x = embed_tokens(params, tokens, cfg, img_embeds)
    x, aux = run_stack(x, params, cfg, _positions(x), remat=remat)
    return apply_norm(x, params["final_norm"], cfg), aux


def _nll(lg, yi):
    lse = torch.logsumexp(lg, dim=-1)
    valid = yi >= 0
    tgt = torch.gather(lg, -1, torch.clamp_min(yi, 0)[..., None])[..., 0]
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def _chunk_nll(params, xi, yi, cfg):
    """Summed negative log-likelihood of one sequence chunk, and its
    count of valid (label >= 0) positions (and codebooks).  Under a mesh
    the (vocab-sharded) logits are gathered over 'model' and each rank
    reduces its own rows: both sums are partial over the data axes."""
    lg = logits_for(params, xi, cfg)                   # (B, C, [K,] V) f32
    rows = ("dp",) + (None,) * (yi.dim() - 1)
    part = layout(partial=("dp",))
    return local_map(_nll, (part, part),
                     (layout(*rows, None), layout(*rows)))(lg, yi)


def _rows(fn, t):
    """``fn(t)`` on each rank's rows of a batch-sharded ``t``."""
    axes = ("dp",) + (None,) * (t.dim() - 1)
    return local_map(fn, layout(*axes), (layout(*axes),))(t)


def loss_fn(params, batch, cfg: ModelConfig, seq_chunk: int = 512,
            remat: bool = True):
    """Mean next-token cross-entropy + 0.01 aux, the reference's.

    ``batch`` holds ``tokens`` and ``labels`` (B, S), or (B, S, K) for a
    codebook model, and for a VLM ``img_embeds`` (B, I, D), whose
    positions take no loss.  The shifted sequence runs in chunks of
    ``seq_chunk`` positions (labels padded with -1 on the sequence
    axis), each chunk's float32 logits made, reduced and, with
    ``remat``, recomputed in the backward pass, so at most one chunk's
    logits is alive; the per-chunk sums accumulate in order.
    """
    tokens, labels = batch["tokens"], batch["labels"]
    img = batch.get("img_embeds")
    x, aux = forward_train(params, tokens, cfg, img_embeds=img, remat=remat)
    if img is not None:
        x = x[:, img.shape[1]:]            # the loss only over the text
    x, y = x[:, :-1], labels[:, 1:]
    b, s = x.shape[:2]
    seq_chunk = min(seq_chunk, s)
    pad = -s % seq_chunk
    if pad:     # on each rank's rows under a mesh
        x = _rows(lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad)), x)
        y = _rows(lambda t: torch.nn.functional.pad(
            t, (0, 0) * (t.dim() - 2) + (0, pad), value=-1), y)
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
               dtype=torch.bfloat16, mesh=None,
               shard_seq: bool = False) -> list:
    """Zeroed decode state, one dict per layer: attention ``k``/``v``
    (B, Hkv, max_len, Dh) in ``dtype``; float32 recurrent and SSM
    states.  With ``mesh`` (a ``DeviceMesh``) every leaf is a DTensor
    placed by ``cache_pspecs(..., shard_seq)`` (validated), each rank
    allocating only its shard; ``device`` is then unused."""
    if mesh is not None:
        from torch.distributed import tensor as dt

        from repro_torch.distributed import sharding as shd

        meta = init_cache(cfg, batch, max_len, "meta", dtype)
        specs = shd.validate_pspecs(
            shd.cache_pspecs(cfg, meta, mesh, shard_seq=shard_seq), meta,
            mesh)
        return shd.map_specs(lambda spec, t: dt.zeros(
            t.shape, dtype=t.dtype, device_mesh=mesh,
            placements=shd.placements(mesh, spec)), specs, meta)
    cache = []
    for kind in cfg.layer_types():
        if kind in ATTENTION_KINDS:
            shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)})
        elif kind == MAMBA:
            cache.append(mam.init_mamba_state(cfg, batch, device))
        else:
            cache.append(rgl.init_recurrent_state(cfg, batch, device))
    return cache


def _attention_layer(x, p, cfg, kind, run):
    """Norm, attention (``run`` -> (h, cache)), post-norm, residual, then
    the MLP or MoE sublayer likewise.  Returns (x, cache, aux)."""
    h, cache = run(apply_norm(x, p["norm1"], cfg))
    h = _sub(h)
    if cfg.use_post_norm:
        h = apply_norm(h, p["post_norm1"], cfg)
    x = x + h
    y = apply_norm(x, p["norm2"], cfg)
    aux = None
    if kind == MOE:
        h, aux = moe_mod.moe_mlp(y, p["moe"], cfg)
    else:
        h = mlp(y, p["mlp"], cfg)
    h = _sub(h)
    if cfg.use_post_norm:
        h = apply_norm(h, p["post_norm2"], cfg)
    return x + h, cache, aux


def _window(cfg, kind):
    return cfg.window_size if kind == ATTN_LOCAL else 0


def _prefill_layer(x, p, cfg, kind, positions, max_len):
    if kind in ATTENTION_KINDS:
        def run(y):
            h, (k, v) = attn.attention_prefill(
                y, p["attn"], cfg, positions, window=_window(cfg, kind),
                cache_len=max_len)
            return h, {"k": k, "v": v}
        return _attention_layer(x, p, cfg, kind, run)[:2]
    pre = mam.mamba_prefill if kind == MAMBA else rgl.recurrent_prefill
    return _ssm_layer(x, p, cfg, kind, lambda y, q: pre(y, q, cfg))


def prefill(params, tokens, cfg: ModelConfig, max_len: int,
            img_embeds=None):
    """Process the prompt (B, S[, K]) after the image prefix, if any;
    returns (last-token logits (B, 1, [K,] V), cache), attention caches
    sized ``max_len`` (which covers I + S).  Under a mesh a batch that
    the data axes do not divide is replicated over them and its
    attention caches shard their sequence over them instead."""
    with batch_rows(tokens.shape[0]):
        return _prefill(params, tokens, cfg, max_len, img_embeds)


def _prefill(params, tokens, cfg, max_len, img_embeds):
    x = embed_tokens(params, tokens, cfg, img_embeds)
    positions = _positions(x)
    cache = []
    for kind, p in zip(cfg.layer_types(), params["layers"]):
        x, c = _prefill_layer(x, p, cfg, kind, positions, max_len)
        cache.append(c)
    x = apply_norm(x, params["final_norm"], cfg)
    return _whole_vocab(logits_for(params, x[:, -1:], cfg)), cache


def _decode_layer(x, p, cfg, kind, cache, cur_len):
    if kind in ATTENTION_KINDS:
        def run(y):
            h, (k, v) = attn.attention_decode(
                y, p["attn"], cfg, (cache["k"], cache["v"]), cur_len,
                window=_window(cfg, kind))
            return h, {"k": k, "v": v}
        return _attention_layer(x, p, cfg, kind, run)[:2]
    dec = mam.mamba_decode if kind == MAMBA else rgl.recurrent_decode
    return _ssm_layer(x, p, cfg, kind, lambda y, q: dec(y, q, cfg, cache))


def decode_step(params, tokens, cache: list, cur_len: int,
                cfg: ModelConfig):
    """One new token per sequence: tokens (B, 1[, K]) at position
    ``cur_len`` (a host int).  Returns (logits (B, 1, [K,] V), cache);
    attention caches are updated in place, recurrent states replaced.
    Under a mesh each layer runs on the cache's layout (a batch-1 cache
    sharded on its sequence by :func:`init_cache`'s ``shard_seq`` or by
    :func:`prefill`)."""
    with batch_rows(tokens.shape[0]):
        return _decode_step(params, tokens, cache, cur_len, cfg)


def _decode_step(params, tokens, cache, cur_len, cfg):
    x = embed_tokens(params, tokens, cfg)
    new_cache = []
    for kind, p, c in zip(cfg.layer_types(), params["layers"], cache):
        x, nc = _decode_layer(x, p, cfg, kind, c, cur_len)
        new_cache.append(nc)
    x = apply_norm(x, params["final_norm"], cfg)
    return _whole_vocab(logits_for(params, x, cfg)), new_cache


def _whole_vocab(logits):
    """Serving's logits under a mesh: rows over the data axes, the whole
    vocabulary on every rank (gathered over 'model'), for the argmax."""
    return constrain(logits, "dp", *(None,) * (logits.dim() - 1))
