"""What the port's four model classes share: the parameter init by one
per-leaf rule, per-layer remat, the MoE routing log, the final norm and
logits.

Each class (``TransformerLM``, ``MambaLM``, ``HybridLM``, ``EncDecLM``)
is functional over an explicit parameter dict, as the reference's are:
``param_shapes`` gives the tree with a ``Spec`` at every leaf, under the
reference's paths, and ``init`` maps ``layers.init_leaf`` over it, so a
caller can make any one leaf -- at a shape of its own -- by the same
rule.  The reference's ``jax.checkpoint`` of a scanned layer is a
per-layer ``torch.utils.checkpoint`` here (``remat``;
``remat_policy="dots"`` saves the matmul outputs without batch dims, as
the reference's ``dots_with_no_batch_dims_saveable``).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import layers as L
from repro_torch.tree import map_with_path, tree_map


def _save_dots(_ctx, op, *args, **_kw):
    """Selective-checkpoint policy "dots": keep the outputs of matmuls
    without batch dims (the projections: ``mm``, and ``bmm`` over a batch
    of one, which is how ``einsum`` runs them), recompute the rest."""
    if op == torch.ops.aten.mm.default or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class LM(nn.Module):
    """Base of the model classes.

    ``moe_log``: None, or a list that every MoE layer appends its
    routing of the real tokens to, ``(idx, keep, margin)``
    (``layers.moe``).  ``shard_act``: None, or the activation-sharding
    hook of a distributed run (``MeshRules.act_sharder()``), applied to
    the (B, S, D) input of every layer of the full-sequence pass, where
    the reference applies it.
    """

    def __init__(self, cfg, remat: bool = True,
                 remat_policy: str | None = None, shard_act=None) -> None:
        super().__init__()
        if remat_policy not in (None, "nothing", "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.cfg = cfg
        self.remat = remat
        self.remat_policy = remat_policy
        self.shard_act = shard_act
        self.moe_log: list | None = None

    def param_shapes(self) -> dict:
        """The parameter tree with a ``Spec`` at every leaf."""
        raise NotImplementedError

    def init(self, gen: torch.Generator) -> dict:
        """Parameters on the generator's device, each leaf made by the
        reference's rule, ``layers.init_leaf(gen, path, spec)``; GQA
        weights with their TP pad slots zeroed (``_zero_pads``)."""
        return self._zero_pads(map_with_path(
            functools.partial(L.init_leaf, gen), self.param_shapes()))

    def _zero_pads(self, params: dict) -> dict:
        return params

    def _act(self, x):
        """``x`` through the ``shard_act`` hook, where one is given."""
        return self.shard_act(x) if self.shard_act else x

    @staticmethod
    def _layer(params, i: int, stack: str = "layers") -> dict:
        """Layer ``i`` of the layer-stacked subtree ``params[stack]``."""
        return tree_map(lambda t: t[i], params[stack])

    def _checkpointed(self, fn, *args):
        """``fn(*args)``, under ``remat`` and autograd checkpointed: its
        activations are recomputed in the backward pass (all of them, or
        all but the matmul outputs under ``remat_policy="dots"``)."""
        if not (self.remat and torch.is_grad_enabled()):
            return fn(*args)
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    def _logits(self, params, x):
        """Final norm, then logits against ``unembed`` (``embed`` where
        the embeddings are tied)."""
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return torch.einsum("bsd,vd->bsv", x,
                            params.get("unembed", params["embed"]))
