"""Uniform model interface of the port: family dispatch, parameter
counts, and the carry of the reference's weights into the port.

Port of the JAX reference's ``repro/models/api.py`` for the families the
port runs (dense, and VLM backbones without patches).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import flatten_with_path, tree_map


def get_model(cfg: ModelConfig) -> TransformerLM:
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP.md, Queue "
            f"1: MoE / MLA / Mamba layers and their configs, other "
            f"families)")
    return TransformerLM(cfg)  # dense | vlm (MoE raises in TransformerLM)


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
    parameters on ``device``, leaf for leaf and bit for bit."""
    return tree_map(lambda a: _tensor(a, device), tree)
