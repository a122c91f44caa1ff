"""Hybrid attention / SSM MoE LM (jamba-1.5-large), in PyTorch.

Port of the JAX reference's ``repro/models/hybrid.py``.  Layers come in
groups of ``cfg.attn_every`` (8): in-group layer 0 is GQA attention
(jamba uses no RoPE), layers 1..7 are Mamba-1 mixers, and after each of
the eight an FFN: the dense MLP at an even in-group index, the
top-k MoE at an odd one.  The parameter tree is the reference's,
``groups/{attn_ln, attn, mamba/{ln, mixer}, mlp/{ln, p}, moe/{ln, p}}``,
stacked ``(G, ...)`` and within a group ``(7, ...)`` or ``(4, ...)``;
it always has ``unembed``.  The reference's ``lax.scan`` over groups is
a Python loop with the pattern unrolled inside, checkpointed per group
under ``remat``.  On a mesh (``base.LM``'s ``par``) each layer runs as
its own family's does: the vocab-parallel embedding, logits and loss,
GQA over this rank's heads (its KV heads, or its cache slots where KV
does not divide ``model``), the Mamba mixers over its d_inner channels
(the ``in_proj`` exchange), the MLPs over F and the MoE layers by their
experts' layout (``layers.moe_sharded``).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.base import LM
from repro_torch.models.layers import Spec
from repro_torch.models.losses import chunked_ce
from repro_torch.tree import tree_map


class HybridLM(LM):
    """Attention + Mamba + MLP / MoE groups (``base.LM``)."""

    @property
    def n_groups(self) -> int:
        return self.cfg.n_layers // self.cfg.attn_every

    @property
    def mamba_per_group(self) -> int:
        return self.cfg.attn_every - 1

    @property
    def ffn_half(self) -> int:
        return self.cfg.attn_every // 2

    # ------------------------------------------------------------- init ----
    def param_shapes(self) -> dict:
        cfg = self.cfg
        G, D = self.n_groups, cfg.d_model
        bf16, f32 = torch.bfloat16, torch.float32

        def stack(lead: tuple, shapes: dict, fp32=()) -> dict:
            return {n: stack(lead, s, fp32) if isinstance(s, dict) else
                    Spec(lead + s, f32 if n in fp32 else bf16)
                    for n, s in shapes.items()}
        m, h = (G, self.mamba_per_group), (G, self.ffn_half)
        group = {
            "attn_ln": Spec((G, D), f32),
            "attn": stack((G,), L.gqa_shapes(cfg)),
            "mamba": {"ln": Spec(m + (D,), f32),
                      "mixer": stack(m, L.mamba_shapes(cfg), L.MAMBA_FP32)},
            "mlp": {"ln": Spec(h + (D,), f32),
                    "p": stack(h, L.mlp_shapes(D, cfg.d_ff, cfg.act))},
            "moe": {"ln": Spec(h + (D,), f32),
                    "p": stack(h, L.moe_shapes(cfg), ("router",))},
        }
        return {"embed": Spec((cfg.vocab_size, D), bf16), "groups": group,
                "final_norm": Spec((D,), f32),
                "unembed": Spec((cfg.vocab_size, D), bf16)}

    def _zero_pads(self, params: dict) -> dict:
        groups = params["groups"]
        groups["attn"] = L.zero_pad_slots(groups["attn"], self.cfg)
        return params

    # ------------------------------------------------------- group body ----
    def _ffn(self, x, g, i: int):
        """FFN of in-group layer i: even -> dense MLP, odd -> MoE."""
        cfg = self.cfg
        if i % 2 == 0:
            sub = tree_map(lambda a: a[i // 2], g["mlp"])
            h = L.rms_norm(x, sub["ln"], cfg.norm_eps)
            return x + L.mlp(h, sub["p"], cfg.act, self._tp(cfg.d_ff))
        sub = tree_map(lambda a: a[(i - 1) // 2], g["moe"])
        h = L.rms_norm(x, sub["ln"], cfg.norm_eps)
        return x + self._moe(h, sub["p"])

    def _group_fwd(self, x, g, q_pos, kv_pos, attn_kv=None, ssm_state=None):
        """Run one group.  Returns (x, (k, v), (h (7,B,Di,N), conv
        (7,B,K-1,Di))).

        attn_kv: None (k/v from x: train / prefill) or the (k, v) cache
        (this rank's slots at ``kv_pos`` where they shard over ``model``).
        ssm_state: None (scan from zero) or (h, conv) to step from.
        """
        cfg = self.cfg
        tp = self._tp(cfg.d_inner)
        h = L.rms_norm(x, g["attn_ln"], cfg.norm_eps)
        k, v = L.gqa_project_kv(h, g["attn"], cfg, kv_pos, self._heads()) \
            if attn_kv is None else attn_kv
        x = x + self._attend_cached(h, g["attn"], k=k, v=v, q_pos=q_pos,
                                    kv_pos=kv_pos,
                                    cached=attn_kv is not None)
        x = self._ffn(x, g, 0)
        hs, convs = [], []
        for i in range(1, cfg.attn_every):
            sub = tree_map(lambda a: a[i - 1], g["mamba"])
            hn = L.rms_norm(x, sub["ln"], cfg.norm_eps)
            if ssm_state is None:
                y, h_fin, conv_tail = L.mamba_scan(hn, sub["mixer"], cfg,
                                                   par=tp)
            else:
                y, h_fin, conv_tail = L.mamba_step(
                    hn, sub["mixer"], cfg, ssm_state[0][i - 1],
                    ssm_state[1][i - 1], par=tp)
            x = self._ffn(x + y, g, i)
            hs.append(h_fin)
            convs.append(conv_tail)
        return x, (k, v), (torch.stack(hs), torch.stack(convs))

    def _group_out(self, x, g, pos):
        return self._group_fwd(self._act(x), g, pos, pos)[0]

    # ---------------------------------------------------------- forward ----
    def _backbone(self, params, batch):
        x = self._lookup(params["embed"], batch["tokens"])
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(self.n_groups):
            x = self._checkpointed(self._group_out, x,
                                   self._layer(params, i, "groups"), pos)
        return x

    def forward(self, params, batch):
        """Full-sequence causal forward -> logits (B, S, V)."""
        return self._logits(params, self._backbone(params, batch))

    def loss(self, params, batch):
        """Next-token CE, chunked over the sequence."""
        x = self._backbone(params, batch)
        return chunked_ce(x, params["unembed"], params["final_norm"],
                          batch["tokens"], self.cfg.norm_eps,
                          par=self._tp(self.cfg.vocab_size))

    # ------------------------------------------------------------ cache ----
    def init_cache(self, B: int, T: int, device=None) -> dict:
        """Zeroed cache: the attention layers' bf16 k/v (G, B, T, KV, hd)
        and the Mamba layers' fp32 state, ``h`` (G, 7, B, Di, N) and
        ``conv`` (G, 7, B, K-1, Di).  On a mesh: this rank's KV heads or
        T / m slots, and its Di / m channels (``B`` is the local
        batch)."""
        cfg = self.cfg
        G, M = self.n_groups, self.mamba_per_group
        kv = (G, B, self._local_slots(T), self._local_kv(), cfg.head_dim)
        tp = self._tp(cfg.d_inner)
        Di = cfg.d_inner // tp.model_size if tp is not None else cfg.d_inner
        return {"k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
                "h": torch.zeros((G, M, B, Di, cfg.ssm_state),
                                 device=device),
                "conv": torch.zeros((G, M, B, cfg.ssm_conv - 1, Di),
                                    device=device)}

    def prefill(self, params, batch, cache_len=None):
        """Process the prompt; returns (last-position logits, cache)."""
        x = self._lookup(params["embed"], batch["tokens"])
        B, S = x.shape[:2]
        T = max(cache_len or S, S)
        pos = torch.arange(S, device=x.device)
        cache = self.init_cache(B, T, device=x.device)
        for i in range(self.n_groups):
            x, (k, v), (h, conv) = self._group_fwd(
                x, self._layer(params, i, "groups"), pos, pos)
            self._fill(cache["k"][i], k)
            self._fill(cache["v"][i], v)
            cache["h"][i], cache["conv"][i] = h, conv
        return self._logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, token, pos: int):
        """One decode step at cache slot ``pos``: the new k/v and the
        Mamba state are written into ``cache`` in place, and the same dict
        returned.  In the sequence-sharded layout only the rank that
        holds slot ``pos`` writes it."""
        cfg = self.cfg
        x = self._lookup(params["embed"], token)
        t0, t1 = self._slot_range(cache["k"].shape[2])
        pos = int(pos)
        q_pos = torch.tensor([pos], device=x.device)
        kv_pos = torch.arange(t0, t1, device=x.device)
        for i in range(self.n_groups):
            g = self._layer(params, i, "groups")
            hn = L.rms_norm(x, g["attn_ln"], cfg.norm_eps)
            k_new, v_new = L.gqa_project_kv(hn, g["attn"], cfg, q_pos,
                                            self._heads())
            if t0 <= pos < t1:
                cache["k"][i, :, pos - t0] = k_new[:, 0]
                cache["v"][i, :, pos - t0] = v_new[:, 0]
            x, _, (h, conv) = self._group_fwd(
                x, g, q_pos, kv_pos, attn_kv=(cache["k"][i], cache["v"][i]),
                ssm_state=(cache["h"][i], cache["conv"][i]))
            cache["h"][i], cache["conv"][i] = h, conv
        return self._logits(params, x)[:, 0], cache
