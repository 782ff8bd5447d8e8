"""Analytic FLOPs / HBM-traffic model per (arch x shape) cell.

A copy of ``repro/utils/flops.py`` over the port's
:mod:`repro_torch.models.config`, its arithmetic unchanged (the tests
hold every cell equal to the reference's).  The counts are exact math
FLOPs of the model's structure, not of what a run dispatches: the
dry-run (:mod:`repro_torch.launch.dryrun`) records
``FlopCounterMode``'s count beside them, and ``tests/test_torch_roofline.py``
holds the forward formulas against that count on a small config.

Conventions:
  * matmul flops = 2*m*n*k; backward = 2x forward matmul flops;
    remat adds ~1x forward recompute -> train multiplier 3 + 1(remat).
  * causal attention context: S/2 average (full), min(w, ~S) (windowed).
  * MoE compute includes the capacity-factor padding overhead (the padded
    (E, C) buffer is what the expert matmuls actually run).

The HBM-traffic model (per chip, per step):
  * parameters stream once per microbatch fwd + once bwd (+1x remat fwd),
    optimizer touches param + 2 moments read/write in f32;
  * activations: ~A_LAYER * d bytes per token per layer through the
    residual stream (reads+writes, bf16), KV cache reads for decode.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ATTN, ATTN_LOCAL, MAMBA, MOE, RECURRENT

BF16 = 2
F32 = 4
A_LAYER = 16  # residual-stream activation bytes/token/layer factor (bf16 rw)


# --------------------------------------------------------------------- #
# forward flops per token, per layer kind
# --------------------------------------------------------------------- #
def _attn_flops_per_token(cfg, ctx: float) -> float:
    d, dh = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * (nq + 2 * nkv) * dh + 2 * d * nq * dh
    scores = 4 * nq * dh * ctx          # qk^T + av
    return proj + scores


def _mlp_flops_per_token(cfg, d_ff: int) -> float:
    mats = 3 if cfg.mlp_gated else 2
    return 2 * mats * cfg.d_model * d_ff


def _moe_flops_per_token(cfg, capacity_factor: float = 1.25) -> float:
    d = cfg.d_model
    router = 2 * d * cfg.n_experts
    routed = cfg.top_k * capacity_factor * 6 * d * cfg.d_expert
    shared = 6 * d * (cfg.n_shared_experts * cfg.d_expert)
    return router + routed + shared


def _mamba_flops_per_token(cfg) -> float:
    d, di, n, dtr, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.dt_rank, cfg.ssm_conv)
    return (2 * d * 2 * di + 2 * di * k + 2 * di * (dtr + 2 * n)
            + 2 * dtr * di + 8 * di * n + 2 * di * d)


def _recurrent_flops_per_token(cfg) -> float:
    d, w, k = cfg.d_model, cfg.lru_width_, cfg.ssm_conv
    return (4 * d * w + 2 * w * k + 4 * w * w + 10 * w + 2 * w * d
            + _mlp_flops_per_token(cfg, cfg.d_ff))


def layer_flops_per_token(cfg, kind: str, ctx: float) -> float:
    if kind == ATTN:
        return _attn_flops_per_token(cfg, ctx) + _mlp_flops_per_token(cfg, cfg.d_ff)
    if kind == ATTN_LOCAL:
        return _attn_flops_per_token(cfg, ctx) + _mlp_flops_per_token(cfg, cfg.d_ff)
    if kind == MOE:
        return _attn_flops_per_token(cfg, ctx) + _moe_flops_per_token(cfg)
    if kind == MAMBA:
        return _mamba_flops_per_token(cfg)
    if kind == RECURRENT:
        return _recurrent_flops_per_token(cfg)
    raise ValueError(kind)


def fwd_flops_per_token(cfg, seq_len: int, decode_ctx: int | None = None) -> float:
    """Average forward flops per token at the given sequence length.

    decode_ctx: if set, attention context is the (fixed) cache length
    (single-token decode) rather than the causal average.
    """
    total = 0.0
    for kind in cfg.layer_types():
        if decode_ctx is not None:
            ctx = min(cfg.window_size, decode_ctx) if kind == ATTN_LOCAL \
                else decode_ctx
        else:
            ctx = min(cfg.window_size, seq_len) if kind == ATTN_LOCAL \
                else seq_len / 2
        total += layer_flops_per_token(cfg, kind, ctx)
    ncb = max(cfg.num_codebooks, 1)
    total += 2 * cfg.d_model * cfg.vocab_size * ncb  # head
    return total


@dataclasses.dataclass
class CellCost:
    flops_per_chip: float
    hbm_bytes_per_chip: float


def cell_cost(cfg, shape, chips: int, model_shards: int, grad_accum: int = 1,
              remat: bool = True, window_cache: bool = False) -> CellCost:
    """Analytic per-chip flops + HBM traffic for one (arch, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    n_params = cfg.param_count()
    params_local = n_params * BF16 / model_shards

    if shape.kind == "train":
        tokens = b * s
        mult = 3.0 + (1.0 if remat else 0.0)
        flops = fwd_flops_per_token(cfg, s) * tokens * mult / chips
        # params stream fwd+bwd(+remat fwd) per microbatch; AdamW touches
        # p (bf16 rw) + m,v (f32 rw) once per step
        param_traffic = grad_accum * (2.0 + (1.0 if remat else 0.0)) * params_local
        opt_traffic = 2 * params_local + 4 * (n_params * F32 / chips)
        act_traffic = (A_LAYER * cfg.d_model * cfg.n_layers
                       * (tokens / chips) * (2.0 if remat else 1.0))
        return CellCost(flops, param_traffic + opt_traffic + act_traffic)

    if shape.kind == "prefill":
        tokens = b * s
        flops = fwd_flops_per_token(cfg, s) * tokens / chips
        act = A_LAYER * cfg.d_model * cfg.n_layers * tokens / chips
        cache = _cache_bytes(cfg, b, s, window_cache) / chips  # cache write
        return CellCost(flops, params_local + act + cache)

    # decode: one token per sequence against a cache of length s
    flops = fwd_flops_per_token(cfg, s, decode_ctx=s) * b / chips
    cache = _cache_bytes(cfg, b, s, window_cache) / chips  # cache read (the wall)
    act = A_LAYER * cfg.d_model * cfg.n_layers * b / chips
    return CellCost(flops, params_local + cache + act)


def _cache_bytes(cfg, b: int, s: int, window_cache: bool = False) -> float:
    """Decode-cache bytes.  The baseline implementation keeps (and reads)
    full-length caches even for sliding-window layers; ``window_cache``
    models the rolling-buffer optimization."""
    total = 0.0
    for kind in cfg.layer_types():
        if kind in (ATTN, MOE):
            total += 2 * b * s * cfg.n_kv_heads * cfg.head_dim_ * BF16
        elif kind == ATTN_LOCAL:
            eff = min(cfg.window_size or s, s) if window_cache else s
            total += 2 * b * eff * cfg.n_kv_heads * cfg.head_dim_ * BF16
        elif kind == MAMBA:
            total += b * cfg.d_inner * (cfg.ssm_state + cfg.ssm_conv - 1) * F32
        elif kind == RECURRENT:
            total += b * cfg.lru_width_ * cfg.ssm_conv * F32
    return total
