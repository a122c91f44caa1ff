"""Uniform model interface of the port: family dispatch, input and
cache specs, random batches, parameter counts, and the carry of the
reference's weights and train state into the port.

Port of the JAX reference's ``repro/models/api.py`` for its six model
families: dense, MoE (with MLA), VLM backbones fed precomputed patch
embeddings, the pure SSM (Mamba-1), the hybrid attention / SSM / MoE
stack and the encoder-decoder fed precomputed frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.base import LM
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.layers import Spec
from repro_torch.models.mamba import MambaLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import flatten_with_path, tree_map


_FAMILIES = {"ssm": MambaLM, "hybrid": HybridLM, "encdec": EncDecLM}


def get_model(cfg: ModelConfig, remat: bool = True, shard_act=None,
              remat_policy: str | None = None, par=None) -> LM:
    """The config's model class: ``MambaLM``, ``HybridLM``, ``EncDecLM``,
    or ``TransformerLM`` for the dense, MoE and VLM families.
    ``shard_act``: None, or the activation-sharding hook
    (``MeshRules.act_sharder()``).  ``remat_policy``: None or
    ``"nothing"`` (recompute every layer activation) or ``"dots"`` (keep
    the matmul outputs).  ``par``: None, or this rank's place on a mesh
    (``distributed.collectives.Par``): the model then computes on this
    rank's shards (``base.LM``)."""
    cls = _FAMILIES.get(cfg.family, TransformerLM)
    return cls(cfg, remat=remat, remat_policy=remat_policy,
               shard_act=shard_act, par=par)


# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: int | None = None) -> dict:
    """``Spec`` stand-ins for every model input of this cell: a decode
    cell's ``{"token": (B, 1)}``, else ``{"tokens": (B, S)}`` int32, for
    a VLM with ``"patches"`` (B, n_patches, d_model) and for an
    encoder-decoder with ``"frames"`` (B, S, d_model), both bf16."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if shape.kind == "decode":
        return {"token": Spec((B, 1), torch.int32)}
    specs = {"tokens": Spec((B, S), torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = Spec((B, cfg.n_patches, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = Spec((B, S, cfg.d_model), torch.bfloat16)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: int | None = None) -> dict:
    """``Spec`` of every leaf of the decode cache of this cell, from the
    model's ``init_cache`` on the meta device (nothing is allocated):
    ``seq_len`` slots, plus the prepended patch positions of a VLM; an
    encoder-decoder's cross caches as long as ``seq_len``."""
    B = batch_override or shape.global_batch
    T = shape.seq_len
    if cfg.family == "vlm":
        T += cfg.n_patches  # the cache covers the patch positions
    model = get_model(cfg)
    kw = {"enc_len": T} if cfg.family == "encdec" else {}
    cache = model.init_cache(B, T, device="meta", **kw)
    return tree_map(lambda t: Spec(tuple(t.shape), t.dtype), cache)


# ---------------------------------------------------------------------------
def make_batch(cfg: ModelConfig, shape: ShapeConfig, rng: np.random.Generator,
               batch_override: int | None = None, device="cuda") -> dict:
    """Random batch matching ``input_specs``: a decode cell's ``{"token":
    (B, 1) int32}``; else ``{"tokens": (B, S) int32}``, for a VLM with
    ``"patches"`` (B, n_patches, d_model) and for an encoder-decoder with
    ``"frames"`` (B, S, d_model), both bf16, drawn from ``rng`` as the
    reference draws them (after the tokens, rounded to bf16 through fp32
    as the reference's ``jnp.asarray`` rounds them), so one seed gives
    both packages the same bits."""
    B, S = batch_override or shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        arr = rng.integers(0, cfg.vocab_size, size=(B, 1))
        return {"token": torch.from_numpy(arr.astype(np.int32)).to(device)}
    arr = rng.integers(0, cfg.vocab_size, size=(B, S))
    out = {"tokens": torch.from_numpy(arr.astype(np.int32)).to(device)}
    extra = {"vlm": ("patches", cfg.n_patches),
             "encdec": ("frames", S)}.get(cfg.family)
    if extra is not None:
        arr = rng.normal(size=(B, extra[1], cfg.d_model))
        out[extra[0]] = torch.from_numpy(arr.astype(np.float32)).to(
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
