"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf].  GELU MLP, LayerNorm,
learned attention biases (qkv_bias=True per released config)."""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49_152,
    layer_pattern=(ATTN,),
    act="gelu",
    norm="layernorm",
    mlp_gated=False,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    arch_id="starcoder2-15b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    layer_pattern=(ATTN,),
    act="gelu",
    norm="layernorm",
    mlp_gated=False,
    qkv_bias=True,
)
