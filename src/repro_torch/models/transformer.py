"""Decoder-only transformer LM: the dense family, in PyTorch.

Port of the JAX reference's ``repro/models/transformer.py`` for dense
models (and VLM backbones run without patches).  Parameters are a
nested dict with the reference's leaf paths and stacked
``(n_layers, ...)`` layer leaves (``layers/attn/wq`` and so on), so a
checkpoint of either package restores in the other.  The reference's
``lax.scan`` over layers is a Python loop over the layer index, and its
``jax.checkpoint`` of the scanned layer is a per-layer
``torch.utils.checkpoint`` (``remat``; ``remat_policy="dots"`` saves
the matmul outputs without batch dims, as the reference's
``dots_with_no_batch_dims_saveable``).  MLA, MoE and patch inputs raise
``NotImplementedError`` until their port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import layers as L
from repro_torch.models.losses import chunked_ce
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of one parameter leaf."""
    shape: tuple
    dtype: torch.dtype


def _save_dots(_ctx, op, *args, **_kw):
    """Selective-checkpoint policy "dots": keep the outputs of matmuls
    without batch dims (the projections: ``mm``, and ``bmm`` over a batch
    of one, which is how ``einsum`` runs them), recompute the rest."""
    if op == torch.ops.aten.mm.default or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: MoE / MLA / Mamba "
        f"layers and their configs)")


class TransformerLM(nn.Module):
    """Functional over an explicit parameter dict, as the reference is:
    ``init`` makes the parameters, the other methods take them."""

    def __init__(self, cfg, remat: bool = True,
                 remat_policy: str | None = None) -> None:
        super().__init__()
        if cfg.use_mla:
            raise _not_ported("MLA attention (use_mla)")
        if cfg.n_experts:
            raise _not_ported("the MoE FFN (n_experts)")
        if remat_policy not in (None, "nothing", "dots"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        self.cfg = cfg
        self.remat = remat
        self.remat_policy = remat_policy

    # ------------------------------------------------------------- init ----
    def param_shapes(self) -> dict:
        """The parameter tree with a ``Spec`` at every leaf."""
        cfg = self.cfg
        nl, D = cfg.n_layers, cfg.d_model
        bf16, f32 = torch.bfloat16, torch.float32
        layer = {"ln1": Spec((nl, D), f32), "ln2": Spec((nl, D), f32),
                 "attn": {n: Spec((nl,) + s, bf16)
                          for n, s in L.gqa_shapes(cfg).items()},
                 "ffn": {n: Spec((nl,) + s, bf16)
                         for n, s in L.mlp_shapes(D, cfg.d_ff,
                                                  cfg.act).items()}}
        shapes = {"embed": Spec((cfg.vocab_size, D), bf16), "layers": layer,
                  "final_norm": Spec((D,), f32)}
        if not cfg.tie_embeddings:
            shapes["unembed"] = Spec((cfg.vocab_size, D), bf16)
        return shapes

    def init(self, gen: torch.Generator) -> dict:
        """Parameters on the generator's device: bf16 weights N(0, 0.02),
        fp32 norm weights at 0 (the norms scale by ``1 + w``)."""
        def make(spec: Spec):
            if spec.dtype == torch.float32:
                return torch.zeros(spec.shape, dtype=spec.dtype,
                                   device=gen.device)
            return L.dense_init(gen, spec.shape, dtype=spec.dtype)
        params = tree_map(make, self.param_shapes())
        layers = params["layers"]
        layers["attn"] = L.zero_pad_slots(layers["attn"], self.cfg)
        return params

    # ------------------------------------------------------------ flags ----
    def _windows(self) -> list[int]:
        """Per-layer sliding-window size; 0 = full/global attention."""
        cfg = self.cfg
        out = []
        for i in range(cfg.n_layers):
            is_global = (i + 1) % cfg.global_every == 0 \
                if cfg.global_every else True
            out.append(0 if is_global else cfg.sliding_window)
        return out

    @staticmethod
    def _layer(params, i: int) -> dict:
        return tree_map(lambda t: t[i], params["layers"])

    # ------------------------------------------------------------ embed ----
    def _embed(self, params, tokens, patches=None):
        if patches is not None:
            raise _not_ported("the multimodal frontend (patches)")
        return params["embed"][tokens]

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        table = params.get("unembed", params["embed"])
        return torch.einsum("bsd,vd->bsv", x, table)

    # ---------------------------------------------------------- forward ----
    def _ffn(self, x, p):
        h2 = L.rms_norm(x, p["ln2"], self.cfg.norm_eps)
        return x + L.mlp(h2, p["ffn"], self.cfg.act)

    def _block(self, x, p, window: int, pos):
        """One decoder layer over the full sequence."""
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        k, v = L.gqa_project_kv(h, p["attn"], cfg, pos)
        x = x + L.gqa_attend(h, p["attn"], cfg, k=k, v=v, q_pos=pos,
                             kv_pos=pos, window=window)
        return self._ffn(x, p)

    def _backbone(self, params, batch):
        """Full-sequence causal pass -> final hidden states (B, S, D).

        Under ``remat`` and autograd each layer is checkpointed: its
        activations are recomputed in the backward pass (all of them, or
        all but the matmul outputs under ``remat_policy="dots"``).
        """
        x = self._embed(params, batch["tokens"], batch.get("patches"))
        pos = torch.arange(x.shape[1], device=x.device)
        remat = self.remat and torch.is_grad_enabled()
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        for i, window in enumerate(self._windows()):
            p = self._layer(params, i)
            if remat:
                x = ckpt.checkpoint(self._block, x, p, window, pos,
                                    use_reentrant=False, **kw)
            else:
                x = self._block(x, p, window, pos)
        return x

    def forward(self, params, batch):
        """Full-sequence causal forward -> logits (B, S, V)."""
        return self._logits(params, self._backbone(params, batch))

    def loss(self, params, batch):
        """Next-token CE, masked to text positions; chunked over the
        sequence so (B, S, V) fp32 logits never materialize."""
        x = self._backbone(params, batch)
        tokens = batch["tokens"]
        P = x.shape[1] - tokens.shape[1]  # prepended patch positions
        table = params.get("unembed", params["embed"])
        return chunked_ce(x, table, params["final_norm"], tokens,
                          self.cfg.norm_eps, skip_prefix=P)

    # ------------------------------------------------------------ cache ----
    def init_cache(self, B: int, T: int, device=None) -> dict:
        """Zeroed bf16 k/v cache, as the reference's: whatever the
        weights' dtype, the cached k/v are rounded to bf16."""
        cfg = self.cfg
        shape = (cfg.n_layers, B, T, cfg.kv_store, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}

    def prefill(self, params, batch, cache_len=None):
        """Process the prompt; returns (last-position logits, cache)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch.get("patches"))
        B, S = x.shape[:2]
        T = max(cache_len or S, S)
        pos = torch.arange(S, device=x.device)
        cache = self.init_cache(B, T, device=x.device)
        for i, window in enumerate(self._windows()):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            k, v = L.gqa_project_kv(h, p["attn"], cfg, pos)
            x = x + L.gqa_attend(h, p["attn"], cfg, k=k, v=v, q_pos=pos,
                                 kv_pos=pos, window=window)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            x = self._ffn(x, p)
        return self._logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, token, pos: int):
        """One decode step. token: (B, 1) integers; pos: the cache slot
        this token occupies.  Returns (logits (B, V), cache).

        The new k/v are written into ``cache`` in place at ``pos`` (the
        reference returns a new cache through ``dynamic_update_slice``);
        the returned cache is the same dict.
        """
        cfg = self.cfg
        x = self._embed(params, token)
        T = cache["k"].shape[2]
        pos = int(pos)
        q_pos = torch.tensor([pos], device=x.device)
        kv_pos = torch.arange(T, device=x.device)
        for i, window in enumerate(self._windows()):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            k_new, v_new = L.gqa_project_kv(h, p["attn"], cfg, q_pos)
            cache["k"][i, :, pos] = k_new[:, 0]
            cache["v"][i, :, pos] = v_new[:, 0]
            x = x + L.gqa_attend(h, p["attn"], cfg, k=cache["k"][i],
                                 v=cache["v"][i], q_pos=q_pos, kv_pos=kv_pos,
                                 window=window)
            x = self._ffn(x, p)
        return self._logits(params, x)[:, 0], cache
