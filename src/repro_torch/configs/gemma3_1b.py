"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 -- 5 local(sliding-window):1 global attention, 128k+ context.
[hf:google/gemma-3-1b-pt]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    sliding_window=512,
    global_every=6,  # layers 5, 11, 17, 23 are global (5 local : 1 global)
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    # 4 q heads on a 16-way model axis: pad to 16 masked slots (kv=1)
    n_heads_padded=16,
)
