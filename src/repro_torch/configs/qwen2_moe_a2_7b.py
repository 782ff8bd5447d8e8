"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  QKV bias like the Qwen dense family.
"""

from repro_torch.models.config import MOE, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    layer_pattern=(MOE,),
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_expert=1408,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    arch_id="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    layer_pattern=(MOE,),
    n_experts=6,
    top_k=2,
    n_shared_experts=2,
    d_expert=64,
    qkv_bias=True,
)
