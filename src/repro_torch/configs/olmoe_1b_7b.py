"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060; hf]."""

from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    layer_pattern=(MOE,),
    n_experts=64,
    top_k=8,
    d_expert=1024,
)

SMOKE = ModelConfig(
    arch_id="olmoe-1b-7b-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    layer_pattern=(MOE,),
    n_experts=8,
    top_k=2,
    d_expert=64,
)
