"""Model configuration covering all assigned architecture families.

One frozen dataclass drives the composable LM in :mod:`repro_torch.models.lm`:
dense / MoE / SSM / hybrid decoder-only transformers plus the audio
(multi-codebook) and VLM (image-prefix) backbone variants.

Layer heterogeneity (gemma2's local/global alternation, recurrentgemma's
2-recurrent:1-attention pattern) is expressed as ``layer_pattern``: the
layer stack is ``pattern * n_rep + tail``.  The reference scans the
repeated pattern with stacked parameters; the port keeps one flat list of
layers in that order (:meth:`ModelConfig.layer_types`).

A copy of the reference's ``repro/models/config.py`` (the port imports
nothing of the reference package).
"""

from __future__ import annotations

import dataclasses
import math

# layer kinds
ATTN = "attn"              # global (full causal) attention + MLP
ATTN_LOCAL = "attn_local"  # sliding-window attention + MLP
MOE = "moe"                # attention + mixture-of-experts MLP
MAMBA = "mamba"            # mamba-1 block (attention-free)
RECURRENT = "recurrent"    # griffin recurrent block (RG-LRU + conv)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    layer_pattern: tuple = (ATTN,)
    window_size: int = 0        # sliding window for ATTN_LOCAL layers
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: float = 0.0   # gemma2: 50.0
    final_softcap: float = 0.0  # gemma2: 30.0
    act: str = "silu"           # mlp activation: silu | gelu
    mlp_gated: bool = True      # SwiGLU/GeGLU vs plain 2-matrix MLP
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    use_post_norm: bool = False # gemma2 sandwich norms
    scale_embeddings: bool = False  # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0
    moe_groups: int = 16    # routing groups (align with data-parallel shards)
    n_experts_pad: int = 0  # pad expert arrays to this count for EP divisibility
    n_heads_pad: int = 0    # pad q heads for TP divisibility (zeroed wo rows)
    # --- SSM (mamba-1) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- RG-LRU (griffin) ---
    lru_width: int = 0          # 0 -> d_model
    # --- modality stubs ---
    num_codebooks: int = 0      # musicgen: 4 parallel EnCodec streams
    img_tokens: int = 0         # llava: anyres patch-embedding prefix length
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------ #
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    def layer_types(self) -> list[str]:
        """Concrete per-layer kinds, length n_layers."""
        p = self.layer_pattern
        reps = self.n_layers // len(p)
        tail = self.n_layers - reps * len(p)
        return list(p) * reps + list(p[:tail])

    @property
    def n_rep(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def tail_types(self) -> tuple:
        tail = self.n_layers - self.n_rep * len(self.layer_pattern)
        return tuple(self.layer_pattern[:tail])

    def has_attention(self) -> bool:
        return any(t in (ATTN, ATTN_LOCAL, MOE) for t in self.layer_types())

    def is_subquadratic(self) -> bool:
        """True if no layer materializes O(S) KV growth at full scope...

        Used to gate the long_500k shape: SSM and hybrid (bounded-window
        attention) archs qualify; gemma2 qualifies for *decode* because its
        global layers read a KV cache linearly per token while local layers
        are bounded.  Pure full-attention archs do not.
        """
        types = set(self.layer_types())
        if types <= {MAMBA, RECURRENT}:
            return True
        if ATTN in types or MOE in types:
            return False
        return True  # local-attention only (+ recurrent)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dh = self.d_model, self.head_dim_
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = 0
        emb = self.vocab_size * d
        if self.num_codebooks:
            emb *= self.num_codebooks
        total += emb
        if not self.tie_embeddings:
            total += d * self.vocab_size * max(self.num_codebooks, 1)
        for t in self.layer_types():
            if t in (ATTN, ATTN_LOCAL, MOE):
                attn = d * (n_q * dh) + 2 * d * (n_kv * dh) + (n_q * dh) * d
                if self.qkv_bias:
                    attn += (n_q + 2 * n_kv) * dh
                total += attn
                mlp_mats = 3 if self.mlp_gated else 2
                if t == MOE:
                    total += d * self.n_experts  # router
                    e = self.n_experts + self.n_shared_experts
                    total += e * 3 * d * self.d_expert
                else:
                    total += mlp_mats * d * self.d_ff
                total += 2 * d  # norms
            elif t == MAMBA:
                di, n, dtr = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * n)
                total += dtr * di + di * n + di + di * d + d
            elif t == RECURRENT:
                w = self.lru_width_
                mlp_mats = 3 if self.mlp_gated else 2
                total += 2 * d * w + w * self.ssm_conv + 2 * w * w \
                    + w * d + 2 * d  # in x2, conv, gates, out, norms
                total += mlp_mats * d * self.d_ff  # griffin MLP block
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dead_experts = self.n_experts - self.top_k
        per_expert = 3 * d * self.d_expert
        return self.param_count() - self.n_layers * dead_experts * per_expert
