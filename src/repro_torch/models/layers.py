"""Neural-net building blocks of the dense transformer, in PyTorch.

Port of the dense part of the JAX reference's ``repro/models/layers.py``:
RMSNorm, LayerNorm, RoPE, GQA attention (a direct einsum path, and a
blockwise flash-style path for long sequences), SwiGLU/GELU MLPs and the
GQA attention layer.  Pure functions over explicit parameter dicts, in
the reference's layouts and precision policy: parameters and activations
in bf16; softmax, norms and RoPE in fp32.  MoE, MLA and Mamba wait for
their port (ROADMAP.md, Queue 1).

The models call ``attention`` here, as the reference's models do; the
hand-written flash kernel is ``repro_torch.kernels.ops.flash_attention``,
which is held against this function.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]

# direct-einsum attention is used when the per-head score tensor is small;
# beyond this, the blockwise (flash-style) path bounds the transient.
ATTN_DIRECT_LIMIT = 4096 * 4096
ATTN_BLOCK_Q = 1024
ATTN_BLOCK_KV = 1024

NEG_INF = -1e30


def dense_init(gen: torch.Generator, shape, scale: float = 0.02,
               dtype=torch.bfloat16) -> torch.Tensor:
    """scale * N(0, 1) drawn in fp32 on the generator's device, cast.

    Scaled in place, so a leaf costs one fp32 copy beside its result (a
    stacked FFN leaf of internlm2-20b is 19 GB in fp32); the bits are
    those of ``(scale * x).to(dtype)``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()
    return out.to(x.dtype)


# ----------------------------------------------------------------- rope ----
@functools.lru_cache(maxsize=16)
def _rope_inv(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The (d/2,) fp32 inverse frequencies, computed in numpy as the
    reference computes them, uploaded once per (d, theta, device): a
    decode step would otherwise copy them to the card at every layer."""
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    return torch.from_numpy(inv).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, half-split convention.

    x: (B, S, H, d) with d even; positions: (S,) or (B, S) integers.
    """
    ang = positions.float()[..., None] * _rope_inv(
        x.shape[-1], theta, x.device)  # (S, d/2) | (B, S, d/2)
    if ang.dim() == 2:  # (S, d/2) -> broadcast over batch
        ang = ang[None]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ---
def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window,
          causal: bool) -> torch.Tensor:
    """(S, T) bool mask from absolute positions; window <= 0 means full."""
    m = torch.ones(q_pos.shape + kv_pos.shape, dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if int(window) > 0:
        m &= kv_pos[None, :] > (q_pos[:, None] - int(window))
    return m


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              window: int = 0, causal: bool = True,
              scale: float | None = None) -> torch.Tensor:
    """GQA attention. q: (B,S,H,dh); k,v: (B,T,KV,dv). Returns (B,S,H,dv).

    Chooses direct einsum vs blockwise lazy-softmax by score-tensor size.
    """
    S, dh = q.shape[1], q.shape[3]
    T = k.shape[1]
    scale = scale or (1.0 / np.sqrt(dh))
    if S * T <= ATTN_DIRECT_LIMIT:
        return _attention_direct(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                 window=window, causal=causal, scale=scale)
    return _attention_blockwise(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                window=window, causal=causal, scale=scale)


def _pv(p: torch.Tensor, v: torch.Tensor, spec: str) -> torch.Tensor:
    """einsum of p (rounded to v's dtype) with v: fp32 sums, v's dtype out
    -- what the reference's ``einsum(p.astype(v.dtype), v)`` gives."""
    return torch.einsum(spec, p.to(v.dtype).float(), v.float()).to(v.dtype)


def _attention_direct(q, k, v, *, q_pos, kv_pos, window, causal, scale):
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dh)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale
    mask = _mask(q_pos, kv_pos, window, causal)  # (S, T)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = _pv(p, v, "bkgst,btkh->bskgh")
    return out.reshape(B, S, H, v.shape[-1])


def _attention_blockwise(q, k, v, *, q_pos, kv_pos, window, causal, scale):
    """Flash-style lazy softmax: a loop over Q blocks, and inside it over
    KV blocks, as the reference's ``lax.map`` over ``lax.scan``.

    Bounds the transient to (B, KV, G, Qb, Tb) whatever the sequence
    length.  The reference's numerics are kept: padded query rows at
    position -1e9 and padded keys at +1e9, and the accumulator in v's
    dtype.
    """
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    Qb, Tb = min(ATTN_BLOCK_Q, S), min(ATTN_BLOCK_KV, T)
    nq, nt = -(-S // Qb), -(-T // Tb)
    dev = q.device
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * Qb - S))
    qposp = F.pad(q_pos, (0, nq * Qb - S), value=-(10 ** 9))
    kp = F.pad(k, (0, 0, 0, 0, 0, nt * Tb - T))
    vp = F.pad(v, (0, 0, 0, 0, 0, nt * Tb - T))
    kposp = F.pad(kv_pos, (0, nt * Tb - T), value=10 ** 9)

    out = torch.empty((B, nq * Qb, H, dv), dtype=v.dtype, device=dev)
    for i in range(nq):
        qg = qp[:, i * Qb:(i + 1) * Qb].reshape(B, Qb, KV, G, dh).float()
        qpos_i = qposp[i * Qb:(i + 1) * Qb]
        m = torch.full((B, KV, G, Qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, Qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, Qb, dv), dtype=v.dtype, device=dev)
        for j in range(nt):
            kj = kp[:, j * Tb:(j + 1) * Tb]
            vj = vp[:, j * Tb:(j + 1) * Tb]
            s = torch.einsum("bqkgh,btkh->bkgqt", qg, kj.float()) * scale
            msk = _mask(qpos_i, kposp[j * Tb:(j + 1) * Tb], window, causal)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _pv(p, vj, "bkgqt,btkh->bkgqh")
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
        out[:, i * Qb:(i + 1) * Qb] = o.permute(0, 3, 1, 2, 4).reshape(
            B, Qb, H, dv)
    return out[:, :S]


# ------------------------------------------------------------------ MLP ----
def mlp(x, p: Params, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:  # gelu
        h = F.gelu(x @ p["wg"], approximate="tanh")
    return h @ p["wd"]


def mlp_shapes(d_model, d_ff, act: str = "swiglu") -> dict:
    s = {"wg": (d_model, d_ff), "wd": (d_ff, d_model)}
    if act == "swiglu":
        s["wu"] = (d_model, d_ff)
    return s


def mlp_init(gen, d_model, d_ff, act: str = "swiglu", dtype=torch.bfloat16):
    return {name: dense_init(gen, shape, dtype=dtype)
            for name, shape in mlp_shapes(d_model, d_ff, act).items()}


# ------------------------------------------------------ GQA attn layer -----
def head_mask(cfg) -> torch.Tensor | None:
    """(H_store,) 1/0 mask of real heads under TP head padding.

    Real head r (original group kv=r//G, slot g=r%G) is stored at index
    kv*G_store + g; everything else is a masked pad slot.
    """
    H, KV = cfg.n_heads, cfg.n_kv_heads
    Hs, KVs = cfg.h_store, cfg.kv_store
    if Hs == H and KVs == KV:
        return None
    G, Gs = H // KV, Hs // KVs
    idx = np.arange(Hs)
    real = ((idx % Gs) < G) & ((idx // Gs) < KV)
    return torch.from_numpy(real.astype(np.float32))


def gqa_shapes(cfg) -> dict:
    D, hd = cfg.d_model, cfg.head_dim
    Hs, KVs = cfg.h_store, cfg.kv_store
    return {"wq": (D, Hs, hd), "wk": (D, KVs, hd), "wv": (D, KVs, hd),
            "wo": (Hs, hd, D)}


def zero_pad_slots(p: Params, cfg) -> Params:
    """GQA weights (layer-stacked or not) with the TP pad slots zeroed
    (outputs are masked anyway)."""
    hm = head_mask(cfg)
    if hm is None:
        return p
    dtype, dev = p["wq"].dtype, p["wq"].device
    hm = hm.to(dev, dtype)
    kvm = (torch.arange(cfg.kv_store, device=dev) < cfg.n_kv_heads).to(dtype)
    return dict(p, wq=p["wq"] * hm[:, None], wo=p["wo"] * hm[:, None, None],
                wk=p["wk"] * kvm[:, None], wv=p["wv"] * kvm[:, None])


def gqa_init(gen, cfg, dtype=torch.bfloat16):
    return zero_pad_slots({name: dense_init(gen, shape, dtype=dtype)
                           for name, shape in gqa_shapes(cfg).items()}, cfg)


def gqa_project_kv(x, p, cfg, positions):
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.use_rope:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_query(x, p, cfg, q_pos):
    """The layer's queries (B, S, H, hd), rotated: what ``gqa_attend``
    attends with."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.use_rope:
        q = rope(q, q_pos, cfg.rope_theta)
    return q


def gqa_attend(x, p, cfg, *, k, v, q_pos, kv_pos, window=0, causal=True):
    q = gqa_query(x, p, cfg, q_pos)
    out = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                    causal=causal)
    hm = head_mask(cfg)
    if hm is not None:
        out = out * hm.to(out.device, out.dtype)[None, None, :, None]
    # a bf16 cache under fp32 weights: promote, as jnp.einsum does
    wo = p["wo"]
    out = out.to(torch.promote_types(out.dtype, wo.dtype))
    return torch.einsum("bshk,hkd->bsd", out, wo.to(out.dtype))
