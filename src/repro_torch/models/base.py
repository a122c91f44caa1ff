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

from repro_torch.distributed.sharding import MeshRules
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_path, map_with_path, tree_map


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
    the reference applies it.  ``par``: None, or this rank's place on a
    mesh of more than one device (``distributed.collectives.Par``): the
    model then runs on this rank's shards of the parameters and the
    caches and holds the collectives itself (the embedding over a V
    shard, column- and row-parallel projections, caches of this rank's
    KV heads or slots, MLA's latent slots, the routed experts over
    ``model`` or the data plane).  Where the ``model`` axis is 1 only
    the MoE layers use it (their groups and experts over the data
    plane); every other op is the one the model runs without a mesh.
    ``batch_sharded``: the tokens are this rank's share of the data
    plane's batch (a serve step sets it false where the plane does not
    divide the batch: every data rank then holds it all).
    """

    def __init__(self, cfg, remat: bool = True,
                 remat_policy: str | None = None, shard_act=None,
                 par=None) -> None:
        super().__init__()
        if remat_policy not in (None, "nothing", "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.cfg = cfg
        self.remat = remat
        self.remat_policy = remat_policy
        self.shard_act = shard_act
        self.par = par
        self.batch_sharded = True
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
        the embeddings are tied): this rank's V shard of them where the
        table shards over ``model``."""
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        vp = self._tp(self.cfg.vocab_size)
        if vp is not None:
            x = vp.copy_to_model(x)
        return torch.einsum("bsd,vd->bsv", x,
                            params.get("unembed", params["embed"]))

    # ------------------------------------------------ tensor parallel --
    def _tp(self, n: int):
        """``par`` where a dim of ``n`` shards over ``model``, else None."""
        return self.par if self.par is not None and self.par.tp(n) \
            else None

    def _heads(self):
        """``par`` where the attention's query heads shard over
        ``model``, else None."""
        return self._tp(self.cfg.h_store)

    def _slots(self):
        """``par`` where the attention caches shard their slots over
        ``model`` (MLA's latent cache, ``MeshRules.latent_cache_spec``;
        GQA's where KV does not divide it, ``MeshRules.cache_spec``),
        else None."""
        par = self.par
        if par is None or par.model_size == 1:
            return None
        return par if self.cfg.use_mla or not par.tp(self.cfg.kv_store) \
            else None

    def _slot_range(self, t_local: int) -> tuple[int, int]:
        """[start, stop) of the cache slots this rank holds, of a cache
        of ``t_local`` slots a rank."""
        sp = self._slots()
        if sp is None:
            return 0, t_local
        r = sp.model.rank
        return r * t_local, (r + 1) * t_local

    def _local_slots(self, T: int) -> int:
        """Slots a rank holds of a cache of ``T``: all of them, or T / m
        in the sequence-sharded layout (which needs m to divide T)."""
        sp = self._slots()
        if sp is None:
            return T
        if T % sp.model_size:
            raise ValueError(f"a cache of {T} slots does not shard over "
                             f"{sp.model_size} devices")
        return T // sp.model_size

    def _local_kv(self) -> int:
        """KV heads a rank's cache holds."""
        hp = self._heads()
        return self.cfg.kv_store // hp.model_size \
            if hp is not None and hp.tp(self.cfg.kv_store) \
            else self.cfg.kv_store

    def _fill(self, slots: torch.Tensor, entry: torch.Tensor) -> None:
        """Writes the entries (B, S, ...) of positions [0, S) into the
        cache slots (B, T, ...) this rank holds."""
        t0, t1 = self._slot_range(slots.shape[1])
        n = max(0, min(t1, entry.shape[1]) - t0)
        slots[:, :n] = entry[:, t0:t0 + n]

    def _lookup(self, table, tokens):
        """``table[tokens]``: where the table shards V over ``model``,
        this rank's rows (the others zero), summed over ``model``."""
        vp = self._tp(self.cfg.vocab_size)
        if vp is None:
            return table[tokens]
        lo, hi = vp.model.chunk(self.cfg.vocab_size)
        idx = tokens - lo
        inside = (idx >= 0) & (idx < hi - lo)
        x = table[torch.where(inside, idx, 0)]
        return vp.reduce_from_model(torch.where(inside[..., None], x, 0))

    def _moe(self, x, p):
        """The MoE FFN of ``x`` (``layers.moe``), on a mesh with this
        rank's tokens and shards (its experts' layout: ``expert_layout``)."""
        return L.moe(x, p, self.cfg, self.moe_log, par=self.par,
                     layout=self.expert_layout,
                     batch_sharded=self.batch_sharded)

    @functools.cached_property
    def expert_layout(self):
        """The spec entries (E, D, F) of the routed experts' ``wg`` on the
        mesh (``MeshRules.param_spec`` without FSDP: the FSDP gathers
        come before the model), or None without a mesh."""
        if self.par is None or not self.cfg.n_experts:
            return None
        rules = MeshRules(self.par.mesh)
        for path, spec in flatten_with_path(self.param_shapes()):
            if path[-1] == "wg" and rules.moe_leaf(path, spec.shape):
                return tuple(rules.param_spec(path, spec.shape))[-3:]
        raise ValueError(f"{self.cfg.name}: no routed-expert leaf")

    def _attend_cached(self, h, p, *, k, v, q_pos, kv_pos, window=0,
                       causal: bool = True, cached: bool = False):
        """GQA attention of ``h`` over ``k`` / ``v``: with ``cached``, a
        cache whose slots may shard over ``model``
        (``layers.gqa_attend_slots``)."""
        sp = self._slots() if cached else None
        if sp is not None:
            return L.gqa_attend_slots(h, p, self.cfg, k=k, v=v, q_pos=q_pos,
                                      kv_pos=kv_pos, slots=sp, window=window,
                                      causal=causal, heads=self._heads())
        return L.gqa_attend(h, p, self.cfg, k=k, v=v, q_pos=q_pos,
                            kv_pos=kv_pos, window=window, causal=causal,
                            par=self._heads())
