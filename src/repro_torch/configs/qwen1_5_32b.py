"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40, i.e. MHA) d_ff=27392
vocab=152064 — QKV bias [hf:Qwen/Qwen1.5-32B; hf].  SwiGLU, RMSNorm."""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    layer_pattern=(ATTN,),
    qkv_bias=True,
)

SMOKE = ModelConfig(
    arch_id="qwen1.5-32b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    layer_pattern=(ATTN,),
    qkv_bias=True,
)
