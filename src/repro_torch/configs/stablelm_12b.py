"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b; hf].  LayerNorm, SwiGLU,
RoPE."""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100_352,
    layer_pattern=(ATTN,),
    norm="layernorm",
)

SMOKE = ModelConfig(
    arch_id="stablelm-12b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    layer_pattern=(ATTN,),
    norm="layernorm",
)
