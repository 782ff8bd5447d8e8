"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048, 4 codebooks
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub: input_specs()
provides the precomputed 4-stream token grid; the backbone embeds each
codebook, sums, and predicts all 4 streams in parallel (delay-pattern
scheduling happens in the tokenizer, outside the backbone).
"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=(ATTN,),
    act="gelu",
    norm="layernorm",
    mlp_gated=False,
    num_codebooks=4,
)

SMOKE = ModelConfig(
    arch_id="musicgen-large-smoke",
    family="audio",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    layer_pattern=(ATTN,),
    act="gelu",
    norm="layernorm",
    mlp_gated=False,
    num_codebooks=4,
)
