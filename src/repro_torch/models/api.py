"""Uniform model interface of the port: family dispatch, random train
batches, parameter counts, and the carry of the reference's
weights and train state into the port.

Port of the JAX reference's ``repro/models/api.py`` for the families the
port runs: dense, MoE (with MLA) and VLM backbones fed precomputed
patch embeddings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import flatten_with_path, tree_map


def get_model(cfg: ModelConfig, remat: bool = True,
              remat_policy: str | None = None) -> TransformerLM:
    """``remat_policy``: None or ``"nothing"`` (recompute every layer
    activation) or ``"dots"`` (keep the matmul outputs)."""
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP.md, Queue "
            f"1 E: the Mamba layers and the other model families)")
    # dense | moe | vlm
    return TransformerLM(cfg, remat=remat, remat_policy=remat_policy)


# ---------------------------------------------------------------------------
def make_batch(cfg: ModelConfig, shape: ShapeConfig, rng: np.random.Generator,
               batch_override: int | None = None, device="cuda") -> dict:
    """Random train batch, ``{"tokens": (B, S) int32}`` and for a VLM
    ``"patches"`` (B, n_patches, d_model) bf16, drawn from ``rng`` as the
    reference draws them (the patches after the tokens, rounded to bf16
    through fp32 as the reference's ``jnp.asarray`` rounds them), so one
    seed gives both packages the same bits.  Decode shapes and the
    frames of the encoder-decoder family come with their ports (ROADMAP.md,
    Queue 1 E and F)."""
    if shape.kind == "decode" or cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"make_batch: only train batches of the dense, MoE and VLM "
            f"families are ported (got {shape.kind!r}, {cfg.family!r})")
    B = batch_override or shape.global_batch
    arr = rng.integers(0, cfg.vocab_size, size=(B, shape.seq_len))
    out = {"tokens": torch.from_numpy(arr.astype(np.int32)).to(device)}
    if cfg.family == "vlm":
        arr = rng.normal(size=(B, cfg.n_patches, cfg.d_model))
        out["patches"] = torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return out


def _unpadded(cfg: ModelConfig) -> ModelConfig:
    """The config without TP head padding."""
    if cfg.n_heads_padded or cfg.n_kv_heads_padded:
        return dataclasses.replace(cfg, n_heads_padded=0,
                                   n_kv_heads_padded=0)
    return cfg


def param_count(cfg: ModelConfig) -> int:
    """Real (non-pad) parameter count -- TP head padding excluded."""
    shapes = get_model(_unpadded(cfg)).param_shapes()
    return int(sum(np.prod(s.shape) for _, s in flatten_with_path(shapes)))


def _routed_expert_params(cfg: ModelConfig, shapes) -> int:
    """Parameters inside the routed experts' weights: the (E, D, F)-family
    leaves (stacked over layers); a shared expert's MLP has no E axis."""
    return int(sum(np.prod(s.shape) for path, s in flatten_with_path(shapes)
                   if path[-1] in ("wg", "wu", "wd")
                   and s.shape[-3:-2] == (cfg.n_experts,)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token touches (MoE: the top-k of the routed experts),
    TP head padding excluded."""
    cfg = _unpadded(cfg)
    shapes = get_model(cfg).param_shapes()
    total = int(sum(np.prod(s.shape) for _, s in flatten_with_path(shapes)))
    if not cfg.n_experts:
        return total
    routed = _routed_expert_params(cfg, shapes)
    return int(total - routed
               + routed * (cfg.experts_per_token / cfg.n_experts))


def _tensor(arr, device) -> torch.Tensor:
    """A host array -> tensor on ``device`` with the same bits.

    bf16 arrives as ``ml_dtypes.bfloat16``, which neither numpy nor
    ``torch.from_numpy`` knows: it crosses as a 16-bit integer view.
    """
    arr = np.array(arr)  # a writable copy in C order
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter tree, as host arrays, -> the port's
    parameters on ``device``, leaf for leaf and bit for bit.

    Any tree of host arrays carries the same way, so the reference's
    train state ``{"params", "opt"}`` comes over whole: the optimizer's
    0-d int32 ``step``, its fp32 ``master`` copy and its moments (fp32,
    or the int8 first moment's ``{"q", "scale"}`` and the bf16 second)
    -- both packages keep the same tree."""
    return tree_map(lambda a: _tensor(a, device), tree)
