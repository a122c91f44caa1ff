"""Uniform model interface of the port: family dispatch, random train
batches, parameter counts, and the carry of the reference's
weights and train state into the port.

Port of the JAX reference's ``repro/models/api.py`` for the families the
port runs (dense, and VLM backbones without patches).
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
            f"1: MoE / MLA / Mamba layers and their configs, other "
            f"families)")
    # dense | vlm (MoE raises in TransformerLM)
    return TransformerLM(cfg, remat=remat, remat_policy=remat_policy)


# ---------------------------------------------------------------------------
def make_batch(cfg: ModelConfig, shape: ShapeConfig, rng: np.random.Generator,
               batch_override: int | None = None, device="cuda") -> dict:
    """Random train batch of a dense model, ``{"tokens": (B, S) int32}``,
    drawn from ``rng`` as the reference draws it, so one seed gives both
    packages the same tokens.  Decode shapes and the inputs of other
    families (patches, frames) come with their ports."""
    if shape.kind == "decode" or cfg.family != "dense":
        raise NotImplementedError(
            f"make_batch: only train batches of dense models are ported "
            f"(got {shape.kind!r}, {cfg.family!r})")
    B = batch_override or shape.global_batch
    arr = rng.integers(0, cfg.vocab_size, size=(B, shape.seq_len))
    return {"tokens": torch.from_numpy(arr.astype(np.int32)).to(device)}


def param_count(cfg: ModelConfig) -> int:
    """Real (non-pad) parameter count -- TP head padding excluded."""
    if cfg.n_heads_padded or cfg.n_kv_heads_padded:
        cfg = dataclasses.replace(cfg, n_heads_padded=0,
                                  n_kv_heads_padded=0)
    shapes = get_model(cfg).param_shapes()
    return int(sum(np.prod(s.shape) for _, s in flatten_with_path(shapes)))


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
