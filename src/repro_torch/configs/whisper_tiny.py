"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865 --
encoder-decoder; conv audio frontend is a stub (input_specs provides
precomputed frame embeddings).
[arXiv:2212.04356]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    is_encoder_decoder=True,
    act="gelu",
    tie_embeddings=True,
    # 6 MHA heads on a 16-way model axis would replicate all attention
    # compute 16x; pad to 16 so it shards (10 masked slots)
    n_heads_padded=16,
    n_kv_heads_padded=16,
)
