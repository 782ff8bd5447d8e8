"""gemma2-2b [dense]: local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000, head_dim 256,
window 4096, attn softcap 50, final softcap 30, GeGLU, sandwich norms,
tied embeddings with sqrt(d) scaling [arXiv:2408.00118; hf].
"""

from repro_torch.models.config import ATTN, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    layer_pattern=(ATTN_LOCAL, ATTN),
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    use_post_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    arch_id="gemma2-2b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    layer_pattern=(ATTN_LOCAL, ATTN),
    window_size=16,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    use_post_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
)
