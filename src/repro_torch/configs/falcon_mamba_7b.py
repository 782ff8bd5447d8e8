"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free mamba-1 blocks,
ssm_state=16, vocab=65024 [arXiv:2410.05355; unverified]."""

from repro_torch.models.config import MAMBA, ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    layer_pattern=(MAMBA,),
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    arch_id="falcon-mamba-7b-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=256,
    layer_pattern=(MAMBA,),
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
)
