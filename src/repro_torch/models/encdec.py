"""Encoder-decoder transformer (whisper-tiny), in PyTorch.

Port of the JAX reference's ``repro/models/encdec.py``.  The audio conv
frontend is a stub, as in the reference: ``frames`` arrive as
precomputed (B, S_enc, d_model) embeddings.  Sinusoidal positions on
both sides, in the reference's two forms: ``sinusoid`` (float64 numpy,
rounded to bf16 through fp32) for the encoder and the decoder's prefill,
``sinusoid_at`` (fp32 on the device) for a decode step, so the port's
prefill and decode differ where the reference's do.  Decoder layers:
causal self-attention (cached), cross-attention over the encoder's k/v
(cached at prefill, non-causal), GELU MLP.  Logits use ``embed``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.base import LM
from repro_torch.models.layers import Spec
from repro_torch.models.losses import chunked_ce


@functools.lru_cache(maxsize=8)
def _sinusoid_host(S: int, D: int) -> np.ndarray:
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / (10_000 ** (2 * i / D))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return out.astype(np.float32)


def sinusoid(S: int, D: int, device=None) -> torch.Tensor:
    """(S, D) positions, computed in float64 and rounded to bf16 through
    fp32, as the reference's ``jnp.asarray`` rounds them."""
    return torch.from_numpy(_sinusoid_host(S, D)).to(
        device=device, dtype=torch.bfloat16)


def sinusoid_at(pos: int, D: int, device=None) -> torch.Tensor:
    """(D,) positions of one decode step, computed in fp32."""
    i = torch.arange(D // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), device=device) / (10_000 ** (2 * i / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(torch.bfloat16)


class EncDecLM(LM):
    """The encoder-decoder (``base.LM``)."""

    # ------------------------------------------------------------- init ----
    def param_shapes(self) -> dict:
        cfg = self.cfg
        D = cfg.d_model
        bf16, f32 = torch.bfloat16, torch.float32

        def stack(n: int, shapes: dict) -> dict:
            return {k: Spec((n,) + s, bf16) for k, s in shapes.items()}
        mlp = L.mlp_shapes(D, cfg.d_ff, cfg.act)
        gqa = L.gqa_shapes(cfg)
        ne, nd = cfg.n_encoder_layers, cfg.n_layers
        return {
            "embed": Spec((cfg.vocab_size, D), bf16),
            "enc_layers": {"ln1": Spec((ne, D), f32), "attn": stack(ne, gqa),
                           "ln2": Spec((ne, D), f32), "mlp": stack(ne, mlp)},
            "enc_norm": Spec((D,), f32),
            "dec_layers": {"ln1": Spec((nd, D), f32),
                           "self_attn": stack(nd, gqa),
                           "ln_x": Spec((nd, D), f32),
                           "cross_attn": stack(nd, gqa),
                           "ln2": Spec((nd, D), f32), "mlp": stack(nd, mlp)},
            "final_norm": Spec((D,), f32),
        }

    def _zero_pads(self, params: dict) -> dict:
        for stack, names in (("enc_layers", ("attn",)),
                             ("dec_layers", ("self_attn", "cross_attn"))):
            for name in names:
                params[stack][name] = L.zero_pad_slots(params[stack][name],
                                                       self.cfg)
        return params

    # ----------------------------------------------------------- encode ----
    def _enc_block(self, x, p, pos):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        k, v = L.gqa_project_kv(h, p["attn"], cfg, pos, self._heads())
        x = x + self._attend_cached(h, p["attn"], k=k, v=v, q_pos=pos,
                                    kv_pos=pos, causal=False)
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(h2, p["mlp"], cfg.act, self._tp(cfg.d_ff))

    def encode(self, params, frames):
        """frames: (B, S_enc, D) stub embeddings -> encoder output."""
        cfg = self.cfg
        S = frames.shape[1]
        x = frames.to(torch.bfloat16) \
            + sinusoid(S, cfg.d_model, frames.device)[None]
        pos = torch.arange(S, device=x.device)
        for i in range(cfg.n_encoder_layers):
            x = self._checkpointed(self._enc_block, x,
                                   self._layer(params, i, "enc_layers"), pos)
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    # ----------------------------------------------------------- decode ----
    def _dec_block(self, x, p, enc_kv, q_pos, kv_pos, self_kv,
                   cached: bool = False):
        """One decoder layer; ``cached``: ``self_kv`` and ``enc_kv`` are
        this rank's cache slots (a decode step), else whole."""
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        k, v = self_kv
        x = x + self._attend_cached(h, p["self_attn"], k=k, v=v,
                                    q_pos=q_pos, kv_pos=kv_pos, cached=cached)
        hx = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
        ek, ev = enc_kv
        e0, e1 = self._slot_range(ek.shape[1]) if cached \
            else (0, ek.shape[1])
        enc_pos = torch.arange(e0, e1, device=x.device)
        x = x + self._attend_cached(hx, p["cross_attn"], k=ek, v=ev,
                                    q_pos=q_pos, kv_pos=enc_pos,
                                    causal=False, cached=cached)
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(h2, p["mlp"], cfg.act, self._tp(cfg.d_ff))

    def _dec_layer(self, x, p, enc, pos):
        """One decoder layer over the full sequence -> (x, its self k/v,
        its cross k/v)."""
        cfg = self.cfg
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        k, v = L.gqa_project_kv(h, p["self_attn"], cfg, pos, self._heads())
        enc_pos = torch.arange(enc.shape[1], device=x.device)
        ek, ev = L.gqa_project_kv(enc, p["cross_attn"], cfg, enc_pos,
                                  self._heads())
        return self._dec_block(x, p, (ek, ev), pos, pos, (k, v)), (k, v), \
            (ek, ev)

    def _dec_out(self, x, p, enc, pos):
        return self._dec_layer(x, p, enc, pos)[0]

    def _embed(self, params, tokens):
        S = tokens.shape[1]
        return self._lookup(params["embed"], tokens) \
            + sinusoid(S, self.cfg.d_model, tokens.device)[None]

    def _backbone(self, params, batch):
        enc = self.encode(params, batch["frames"])
        x = self._embed(params, batch["tokens"])
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(self.cfg.n_layers):
            x = self._checkpointed(self._dec_out, x,
                                   self._layer(params, i, "dec_layers"),
                                   enc, pos)
        return x

    def forward(self, params, batch):
        """Teacher-forced forward -> decoder logits (B, S, V)."""
        return self._logits(params, self._backbone(params, batch))

    def loss(self, params, batch):
        """Next-token CE of the decoder, chunked over the sequence."""
        x = self._backbone(params, batch)
        return chunked_ce(x, params["embed"], params["final_norm"],
                          batch["tokens"], self.cfg.norm_eps,
                          par=self._tp(self.cfg.vocab_size))

    # ------------------------------------------------------------ cache ----
    def init_cache(self, B: int, T: int, enc_len: int = 0,
                   device=None) -> dict:
        """Zeroed bf16 cache: self-attention k/v (L, B, T, KV, hd) and
        cross-attention ``ek`` / ``ev`` (L, B, enc_len, KV, hd); on a mesh,
        this rank's KV heads or slots."""
        cfg = self.cfg
        kv = self._local_kv()
        shape = (cfg.n_layers, B, self._local_slots(T), kv, cfg.head_dim)
        enc_shape = (cfg.n_layers, B, self._local_slots(enc_len), kv,
                     cfg.head_dim)
        return {name: torch.zeros(s, dtype=torch.bfloat16, device=device)
                for name, s in (("k", shape), ("v", shape),
                                ("ek", enc_shape), ("ev", enc_shape))}

    def prefill(self, params, batch, cache_len=None):
        """Encode the frames, run the prompt; fills both caches.  Returns
        (last-position logits, cache)."""
        enc = self.encode(params, batch["frames"])
        x = self._embed(params, batch["tokens"])
        B, S = x.shape[:2]
        T = max(cache_len or S, S)
        pos = torch.arange(S, device=x.device)
        cache = self.init_cache(B, T, enc.shape[1], device=x.device)
        for i in range(self.cfg.n_layers):
            x, (k, v), (ek, ev) = self._dec_layer(
                x, self._layer(params, i, "dec_layers"), enc, pos)
            for name, entry in (("k", k), ("v", v), ("ek", ek), ("ev", ev)):
                self._fill(cache[name][i], entry)
        return self._logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, token, pos: int):
        """One decode step at cache slot ``pos``: the new self-attention
        k/v are written into ``cache`` in place, and the same dict
        returned."""
        cfg = self.cfg
        pos = int(pos)
        x = self._lookup(params["embed"], token) \
            + sinusoid_at(pos, cfg.d_model, token.device)[None, None]
        t0, t1 = self._slot_range(cache["k"].shape[2])
        q_pos = torch.tensor([pos], device=x.device)
        kv_pos = torch.arange(t0, t1, device=x.device)
        for i in range(cfg.n_layers):
            p = self._layer(params, i, "dec_layers")
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            k_new, v_new = L.gqa_project_kv(h, p["self_attn"], cfg, q_pos,
                                            self._heads())
            if t0 <= pos < t1:
                cache["k"][i, :, pos - t0] = k_new[:, 0]
                cache["v"][i, :, pos - t0] = v_new[:, 0]
            x = self._dec_block(x, p, (cache["ek"][i], cache["ev"][i]),
                                q_pos, kv_pos,
                                (cache["k"][i], cache["v"][i]), cached=True)
        return self._logits(params, x)[:, 0], cache
