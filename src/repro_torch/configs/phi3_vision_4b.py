"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 -- phi3-mini backbone + CLIP frontend (stub: input_specs
provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    n_patches=576,  # CLIP ViT-L/14 @ 336px -> 24x24 patch embeddings (stub)
)
