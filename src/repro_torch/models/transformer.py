"""Decoder-only transformer LM: the dense, MoE, MLA and VLM-backbone
families, in PyTorch.

Port of the JAX reference's ``repro/models/transformer.py``.  Parameters
are a nested dict with the reference's leaf paths and stacked
``(n_layers, ...)`` layer leaves (``layers/attn/wq``,
``layers/ffn/router`` and so on), so a checkpoint of either package
restores in the other.  The attention is GQA or MLA (with its latent
``c`` / ``kr`` cache, attended absorbed at decode) and the FFN an MLP or
the top-k MoE, by the config.  ``patches`` (image embeddings at
``d_model``) are prepended to the token embeddings, so positions, the
cache and the loss's skipped prefix cover them.  The reference's
``lax.scan`` over layers is a Python loop over the layer index, and its
``jax.checkpoint`` of the scanned layer is a per-layer
``torch.utils.checkpoint`` (``remat``; ``remat_policy="dots"`` saves
the matmul outputs without batch dims, as the reference's
``dots_with_no_batch_dims_saveable``: the MoE's expert products, batched
over the experts, are recomputed).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.base import LM
from repro_torch.models.layers import Spec
from repro_torch.models.losses import chunked_ce


class TransformerLM(LM):
    """The dense, MoE, MLA and VLM-backbone decoder (``base.LM``)."""

    # ------------------------------------------------------------- init ----
    def param_shapes(self) -> dict:
        """The parameter tree with a ``Spec`` at every leaf."""
        cfg = self.cfg
        nl, D = cfg.n_layers, cfg.d_model
        bf16, f32 = torch.bfloat16, torch.float32

        def stack(shapes: dict, fp32=()) -> dict:
            return {n: stack(s) if isinstance(s, dict) else
                    Spec((nl,) + s, f32 if n in fp32 else bf16)
                    for n, s in shapes.items()}
        attn = stack(L.mla_shapes(cfg), L.MLA_NORMS) if cfg.use_mla \
            else stack(L.gqa_shapes(cfg))
        ffn = stack(L.moe_shapes(cfg), ("router",)) if cfg.n_experts \
            else stack(L.mlp_shapes(D, cfg.d_ff, cfg.act))
        layer = {"ln1": Spec((nl, D), f32), "ln2": Spec((nl, D), f32),
                 "attn": attn, "ffn": ffn}
        shapes = {"embed": Spec((cfg.vocab_size, D), bf16), "layers": layer,
                  "final_norm": Spec((D,), f32)}
        if not cfg.tie_embeddings:
            shapes["unembed"] = Spec((cfg.vocab_size, D), bf16)
        return shapes

    def _zero_pads(self, params: dict) -> dict:
        params["layers"]["attn"] = L.zero_pad_slots(params["layers"]["attn"],
                                                    self.cfg)
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

    # ------------------------------------------------------------ embed ----
    def _embed(self, params, tokens, patches=None):
        x = self._lookup(params["embed"], tokens)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    # ---------------------------------------------------------- forward ----
    def _ffn(self, x, p):
        cfg = self.cfg
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.n_experts:
            return x + self._moe(h2, p["ffn"])
        return x + L.mlp(h2, p["ffn"], cfg.act, self._tp(cfg.d_ff))

    def _attend(self, h, p, window: int, pos):
        """The layer's attention over the full sequence -> (its output,
        the cache entries: MLA's (c, kr) or GQA's (k, v))."""
        cfg = self.cfg
        if cfg.use_mla:
            c, kr = L.mla_latent(h, p["attn"], cfg, pos)
            return L.mla_attend_naive(h, p["attn"], cfg, c=c, k_rope=kr,
                                      q_pos=pos, kv_pos=pos,
                                      par=self._tp(cfg.n_heads)), (c, kr)
        k, v = L.gqa_project_kv(h, p["attn"], cfg, pos, self._heads())
        return self._attend_cached(h, p["attn"], k=k, v=v, q_pos=pos,
                                   kv_pos=pos, window=window), (k, v)

    def _block(self, x, p, window: int, pos):
        """One decoder layer over the full sequence."""
        x = self._act(x)
        h = L.rms_norm(x, p["ln1"], self.cfg.norm_eps)
        return self._ffn(x + self._attend(h, p, window, pos)[0], p)

    def _backbone(self, params, batch):
        """Full-sequence causal pass -> final hidden states (B, S, D).

        Under ``remat`` and autograd each layer is checkpointed: its
        activations are recomputed in the backward pass (all of them, or
        all but the matmul outputs under ``remat_policy="dots"``).
        """
        x = self._embed(params, batch["tokens"], batch.get("patches"))
        pos = torch.arange(x.shape[1], device=x.device)
        for i, window in enumerate(self._windows()):
            x = self._checkpointed(self._block, x, self._layer(params, i),
                                   window, pos)
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
                          self.cfg.norm_eps, skip_prefix=P,
                          par=self._tp(self.cfg.vocab_size))

    # ------------------------------------------------------------ cache ----
    def _cache_names(self) -> tuple[str, str]:
        return ("c", "kr") if self.cfg.use_mla else ("k", "v")

    def init_cache(self, B: int, T: int, device=None) -> dict:
        """Zeroed bf16 cache, as the reference's: whatever the weights'
        dtype, the cached entries are rounded to bf16.  GQA caches k/v
        (L, B, T, KV, hd); MLA its latent ``c`` (L, B, T, kv_lora_rank)
        and rotated key part ``kr`` (L, B, T, qk_rope_head_dim).  On a
        mesh: this rank's KV heads, or its T / m slots (MLA's always:
        ``MeshRules.latent_cache_spec``; ``B`` is the local batch)."""
        cfg = self.cfg
        nl = cfg.n_layers
        if cfg.use_mla:
            t = self._local_slots(T)
            shapes = ((nl, B, t, cfg.kv_lora_rank),
                      (nl, B, t, cfg.qk_rope_head_dim))
        else:
            shapes = ((nl, B, self._local_slots(T), self._local_kv(),
                       cfg.head_dim),) * 2
        return {name: torch.zeros(shape, dtype=torch.bfloat16, device=device)
                for name, shape in zip(self._cache_names(), shapes)}

    def prefill(self, params, batch, cache_len=None):
        """Process the prompt; returns (last-position logits, cache)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch.get("patches"))
        B, S = x.shape[:2]
        T = max(cache_len or S, S)
        pos = torch.arange(S, device=x.device)
        cache = self.init_cache(B, T, device=x.device)
        names = self._cache_names()
        for i, window in enumerate(self._windows()):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            att, entries = self._attend(h, p, window, pos)
            for name, entry in zip(names, entries):
                self._fill(cache[name][i], entry)
            x = self._ffn(x + att, p)
        return self._logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, token, pos: int):
        """One decode step. token: (B, 1) integers; pos: the cache slot
        this token occupies.  Returns (logits (B, V), cache).

        The new cache entries (GQA's k/v, MLA's c/kr) are written into
        ``cache`` in place at ``pos`` (the reference returns a new cache
        through ``dynamic_update_slice``); the returned cache is the same
        dict.  MLA attends absorbed, against the latent cache itself.  In
        the sequence-sharded layout (MLA's on a mesh, GQA's where KV does
        not divide ``model``) only the rank that holds slot ``pos``
        writes it.
        """
        cfg = self.cfg
        x = self._embed(params, token)
        names = self._cache_names()
        t0, t1 = self._slot_range(cache[names[0]].shape[2])
        pos = int(pos)
        q_pos = torch.tensor([pos], device=x.device)
        kv_pos = torch.arange(t0, t1, device=x.device)
        for i, window in enumerate(self._windows()):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            if cfg.use_mla:
                entries = L.mla_latent(h, p["attn"], cfg, q_pos)
            else:
                entries = L.gqa_project_kv(h, p["attn"], cfg, q_pos,
                                           self._heads())
            if t0 <= pos < t1:
                for name, entry in zip(names, entries):
                    cache[name][i, :, pos - t0] = entry[:, 0]
            a, b = cache[names[0]][i], cache[names[1]][i]
            if cfg.use_mla:
                att = L.mla_attend_absorbed(
                    h, p["attn"], cfg, c=a, k_rope=b, q_pos=q_pos,
                    kv_pos=kv_pos, slots=self._slots(),
                    heads=self._tp(cfg.n_heads))
            else:
                att = self._attend_cached(h, p["attn"], k=a, v=b,
                                          q_pos=q_pos, kv_pos=kv_pos,
                                          window=window, cached=True)
            x = self._ffn(x + att, p)
        return self._logits(params, x)[:, 0], cache
