"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536 -- Mamba:attention 7:1 interleave, MoE 16 experts
top-2 on every other layer (-> 398B total / ~94B active).
[arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    # hybrid pattern: 1 attention layer per 8 (1:7 attn:mamba)
    attn_every=8,
    ssm_state=16,
    ssm_conv=4,
    d_inner=16_384,
    # MoE every other layer, 16 experts top-2
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_d_ff=24_576,
    moe_group_size=512,
    scan_group=8,
    use_rope=False,  # jamba uses no positional encoding (mamba provides it)
    # ssm_compute_dtype="bf16" was tried and REFUTED (no traffic change,
    # SSPerf cell 2 iter 4) -- stays fp32
)
