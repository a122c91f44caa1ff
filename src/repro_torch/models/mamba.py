"""Pure-SSM LM (falcon-mamba-7b): a stack of Mamba-1 blocks, in PyTorch.

Port of the JAX reference's ``repro/models/mamba.py``.  Attention-free:
each layer is RMSNorm -> Mamba block -> residual (Mamba-1 has no
separate FFN).  The decode state is O(1) per layer: the (Di, N) fp32 SSM
state and the (K-1, Di) fp32 conv tail.  Leaves sit under the
reference's paths (``layers/ln``, ``layers/mixer/in_proj`` ...), stacked
``(n_layers, ...)``; falcon-mamba ties its logits to ``embed``.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.base import LM
from repro_torch.models.layers import Spec
from repro_torch.models.losses import chunked_ce


class MambaLM(LM):
    """The Mamba-1 stack (``base.LM``)."""

    def param_shapes(self) -> dict:
        cfg = self.cfg
        nl, D = cfg.n_layers, cfg.d_model
        bf16, f32 = torch.bfloat16, torch.float32
        mixer = {n: Spec((nl,) + s, f32 if n in L.MAMBA_FP32 else bf16)
                 for n, s in L.mamba_shapes(cfg).items()}
        shapes = {"embed": Spec((cfg.vocab_size, D), bf16),
                  "layers": {"ln": Spec((nl, D), f32), "mixer": mixer},
                  "final_norm": Spec((D,), f32)}
        if not cfg.tie_embeddings:
            shapes["unembed"] = Spec((cfg.vocab_size, D), bf16)
        return shapes

    def _block(self, x, p):
        x = self._act(x)
        h = L.rms_norm(x, p["ln"], self.cfg.norm_eps)
        return x + L.mamba_scan(h, p["mixer"], self.cfg,
                                par=self._tp(self.cfg.d_inner))[0]

    # ---------------------------------------------------------- forward ----
    def _backbone(self, params, batch):
        x = self._lookup(params["embed"], batch["tokens"])
        for i in range(self.cfg.n_layers):
            x = self._checkpointed(self._block, x, self._layer(params, i))
        return x

    def forward(self, params, batch):
        """Full-sequence forward -> logits (B, S, V)."""
        return self._logits(params, self._backbone(params, batch))

    def loss(self, params, batch):
        """Next-token CE, chunked over the sequence."""
        x = self._backbone(params, batch)
        return chunked_ce(x, params.get("unembed", params["embed"]),
                          params["final_norm"], batch["tokens"],
                          self.cfg.norm_eps,
                          par=self._tp(self.cfg.vocab_size))

    # ------------------------------------------------------------ cache ----
    def init_cache(self, B: int, T: int, device=None) -> dict:
        """Zeroed fp32 state, O(1) in the sequence (``T`` unused): ``h``
        (L, B, Di, N) and ``conv`` (L, B, K-1, Di); on a mesh, this
        rank's Di / m channels."""
        cfg = self.cfg
        del T
        tp = self._tp(cfg.d_inner)
        Di = cfg.d_inner // tp.model_size if tp is not None else cfg.d_inner
        return {"h": torch.zeros((cfg.n_layers, B, Di, cfg.ssm_state),
                                 device=device),
                "conv": torch.zeros((cfg.n_layers, B, cfg.ssm_conv - 1, Di),
                                    device=device)}

    def prefill(self, params, batch, cache_len=None):
        """Scan the prompt; returns (last-position logits, the state after
        it)."""
        cfg = self.cfg
        x = self._lookup(params["embed"], batch["tokens"])
        cache = self.init_cache(x.shape[0], 0, device=x.device)
        tp = self._tp(cfg.d_inner)
        for i in range(cfg.n_layers):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln"], cfg.norm_eps)
            y, cache["h"][i], cache["conv"][i] = L.mamba_scan(
                h, p["mixer"], cfg, par=tp)
            x = x + y
        return self._logits(params, x[:, -1:, :])[:, 0], cache

    def decode_step(self, params, cache, token, pos: int):
        """One decode step (position-free); the state is updated in place
        and the same dict returned."""
        cfg = self.cfg
        del pos
        x = self._lookup(params["embed"], token)
        tp = self._tp(cfg.d_inner)
        for i in range(cfg.n_layers):
            p = self._layer(params, i)
            h = L.rms_norm(x, p["ln"], cfg.norm_eps)
            y, cache["h"][i], cache["conv"][i] = L.mamba_step(
                h, p["mixer"], cfg, cache["h"][i], cache["conv"][i], par=tp)
            x = x + y
        return self._logits(params, x)[:, 0], cache
