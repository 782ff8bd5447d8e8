"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6-34b-hf; unverified].

The vision tower + anyres tiling is a STUB: ``input_specs()`` supplies
precomputed patch embeddings (B, img_tokens, d_model) prepended to the
text sequence; img_tokens=2880 covers the 672x672 anyres grid
(5 tiles x 24x24 patches).
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    layer_pattern=(ATTN,),
    img_tokens=2880,
    rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    arch_id="llava-next-34b-smoke",
    family="vlm",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    layer_pattern=(ATTN,),
    img_tokens=16,
    rope_theta=5_000_000.0,
)
