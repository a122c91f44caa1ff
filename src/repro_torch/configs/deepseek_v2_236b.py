"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed experts top-6.
[arXiv:2405.04434; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,  # per-expert FFN dim (assignment spec)
    vocab_size=102_400,
    # MoE: 160 routed top-6 + 2 shared experts
    n_experts=160,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    moe_group_size=512,
    # MLA
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
)
