"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, head_dim 256,
lru_width 4096, local window 2048 [arXiv:2402.19427; unverified].
Pattern = (recurrent, recurrent, local attention) x 12 + 2 recurrent tail.
"""

from repro_torch.models.config import ATTN_LOCAL, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    layer_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
    window_size=2048,
    lru_width=4096,
    act="gelu",
    scale_embeddings=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    layer_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
    window_size=16,
    lru_width=64,
    act="gelu",
    scale_embeddings=True,
    tie_embeddings=True,
)
