"""falcon-mamba-7b [ssm]: 64L d_model=4096 attention-free, ssm_state=16
vocab=65024 -- mamba1 architecture.
[arXiv:2410.05355]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,  # attention-free: the mamba block is the whole layer
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    d_inner=8192,
    tie_embeddings=True,
)
