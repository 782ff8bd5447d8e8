"""demo-100m: ~100M-parameter decoder-only LM for the end-to-end training
example (not an assigned architecture)."""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="demo-100m",
    family="dense",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32_000,
)

SMOKE = CONFIG
