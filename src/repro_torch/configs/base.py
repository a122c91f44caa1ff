"""Model / shape configuration, copied from the JAX reference.

``ModelConfig``, ``ShapeConfig``, ``SHAPES``, ``ARCH_IDS`` and
``runnable_cells`` are the reference's (``repro/configs/base.py``), with
only the imports changed.
Each architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``reduced()`` derives the same-family small
config the CPU tests use.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (if different from d_ff)
    moe_every: int = 1  # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    moe_group_size: int = 1024  # tokens per dispatch group

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- attention pattern ---
    sliding_window: int = 0  # 0 = full attention
    global_every: int = 0  # gemma3: 1 global layer per k (5 local : 1 global)
    # TP head padding: store H/KV padded to a mesh-divisible count with
    # zeroed+masked pad slots (Megatron-style) so attention weights shard
    # instead of replicating.  0 = no padding.
    n_heads_padded: int = 0
    n_kv_heads_padded: int = 0

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    dt_rank: int = 0
    attn_every: int = 0  # jamba: 1 attention layer per k (1:7 -> 8)
    # dtype of the within-chunk scan tensors (B,c,Di,N); the cross-chunk
    # carry stays fp32 either way.  bf16 halves the SSM's HBM traffic at
    # a known precision trade (SSPerf cell 2 iteration 4).
    ssm_compute_dtype: str = "fp32"

    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0

    # --- multimodal frontend stub ---
    n_patches: int = 0  # image/audio embeddings prepended (input_specs stub)

    # --- misc ---
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    act: str = "swiglu"  # swiglu | gelu
    scan_group: int = 1  # layers per scan step (pattern period)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.ssm_state and not self.d_inner:
            object.__setattr__(self, "d_inner", 2 * self.d_model)
        if self.ssm_state and not self.dt_rank:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    # ------------------------------------------------------------------
    @property
    def h_store(self) -> int:
        """Stored (possibly padded) query-head count."""
        return self.n_heads_padded or self.n_heads

    @property
    def kv_store(self) -> int:
        return self.n_kv_heads_padded or self.n_kv_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k-token decode? (SSM/hybrid/sliding-window)"""
        return bool(self.ssm_state) or bool(self.sliding_window)

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def param_count(self) -> int:
        """Parameter count from the port's own parameter shapes."""
        from repro_torch.models import api
        return api.param_count(self)

    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: the top-k of the routed
        experts), from the port's own parameter shapes."""
        from repro_torch.models import api
        return api.active_param_count(self)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        def shrink(v, cap):
            return min(v, cap) if v else v
        period = max(self.scan_group, self.attn_every, self.global_every,
                     self.moe_every, 1)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, 2 * period),
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            d_model=128,
            n_heads=max(1, min(self.n_heads, 4)),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=shrink(self.d_ff, 256),
            vocab_size=512,
            n_experts=shrink(self.n_experts, 8),
            experts_per_token=shrink(self.experts_per_token, 2),
            moe_d_ff=shrink(self.moe_d_ff, 128),
            moe_group_size=64,
            # no token dropping in smoke tests: keeps grouped prefill
            # dispatch and single-token decode dispatch bit-consistent
            capacity_factor=4.0,
            kv_lora_rank=shrink(self.kv_lora_rank, 32),
            q_lora_rank=shrink(self.q_lora_rank, 32),
            qk_nope_head_dim=32 if self.use_mla else self.qk_nope_head_dim,
            qk_rope_head_dim=16 if self.use_mla else self.qk_rope_head_dim,
            v_head_dim=32 if self.use_mla else self.v_head_dim,
            d_inner=256 if self.ssm_state else 0,
            dt_rank=8 if self.ssm_state else 0,
            sliding_window=shrink(self.sliding_window, 64),
            n_patches=shrink(self.n_patches, 16),
            # keep head padding exercised in smoke tests when present
            n_heads_padded=8 if self.n_heads_padded else 0,
            n_kv_heads_padded=4 if self.n_kv_heads_padded else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "deepseek_v2_236b",
    "granite_moe_1b",
    "phi3_vision_4b",
    "whisper_tiny",
    "gemma3_1b",
    "deepseek_coder_33b",
    "llama32_1b",
    "internlm2_20b",
    "falcon_mamba_7b",
    "jamba_15_large",
]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, honouring the long_500k skip rule."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.is_subquadratic:
                continue  # pure full attention: the reference skips it
            cells.append((arch, shape.name))
    return cells
