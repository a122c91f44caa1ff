"""Neural-net building blocks of the four model families, in PyTorch.

Port of the JAX reference's ``repro/models/layers.py``: RMSNorm,
LayerNorm, RoPE, GQA attention (a direct einsum path, and a blockwise
flash-style path for long sequences), SwiGLU/GELU MLPs, the GQA
attention layer, MLA latent attention (the naive train/prefill path and
the absorbed decode path), the capacity-based top-k MoE FFN and the
Mamba-1 selective SSM block (a chunked scan and the one-token decode
step).  Pure functions over explicit parameter dicts, in the
reference's layouts and precision policy: parameters and activations in
bf16; softmax, norms, RoPE, the router and the SSM state in fp32.

The models call ``attention`` here, as the reference's models do; the
hand-written flash kernel is ``repro_torch.kernels.ops.flash_attention``,
which is held against this function.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch._guards import detect_fake_mode

Params = dict[str, Any]

# direct-einsum attention is used when the per-head score tensor is small;
# beyond this, the blockwise (flash-style) path bounds the transient.
ATTN_DIRECT_LIMIT = 4096 * 4096
ATTN_BLOCK_Q = 1024
ATTN_BLOCK_KV = 1024
SSM_CHUNK = 64
# the iterator of ``_attention_blockwise``'s loops over blocks; the dry
# run swaps in one that runs a single block for all of them
_blocks = range

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape and dtype of one parameter leaf."""
    shape: tuple
    dtype: torch.dtype


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
def _rope_inv_np(d: int, theta: float) -> np.ndarray:
    """The (d/2,) fp32 inverse frequencies, computed in numpy as the
    reference computes them."""
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))


@functools.lru_cache(maxsize=16)
def _rope_inv_on(d: int, theta: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rope_inv_np(d, theta)).to(device)


def _rope_inv(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """``_rope_inv_np`` on ``device``, uploaded once per (d, theta,
    device): a decode step would otherwise copy it to the card at every
    layer.  Under a fake mode (the dry run's traces) it is made anew: a
    memoised fake tensor would reach the next fake mode, or a real run."""
    if detect_fake_mode() is not None:
        return torch.from_numpy(_rope_inv_np(d, theta)).to(device)
    return _rope_inv_on(d, theta, device)


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
    for i in _blocks(nq):
        qg = qp[:, i * Qb:(i + 1) * Qb].reshape(B, Qb, KV, G, dh).float()
        qpos_i = qposp[i * Qb:(i + 1) * Qb]
        m = torch.full((B, KV, G, Qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, Qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, Qb, dv), dtype=v.dtype, device=dev)
        for j in _blocks(nt):
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
def mlp(x, p: Params, act: str = "swiglu", par=None):
    """SwiGLU or GELU MLP.  ``par``: the tensor-parallel context where F
    shards over ``model`` (``wg`` / ``wu`` column-, ``wd`` row-parallel:
    the output all-reduced); None where the weights are whole."""
    if par is not None:
        x = par.copy_to_model(x)
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:  # gelu
        h = F.gelu(x @ p["wg"], approximate="tanh")
    y = h @ p["wd"]
    return y if par is None else par.reduce_from_model(y)


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


def local_head_mask(cfg, par=None) -> torch.Tensor | None:
    """``head_mask`` of this rank's query heads (all of them without a
    tensor-parallel context)."""
    hm = head_mask(cfg)
    if hm is None or par is None:
        return hm
    h0, h1 = par.model.chunk(cfg.h_store)
    return hm[h0:h1]


def kv_of_heads(cfg, par) -> tuple[int, int]:
    """[start, stop) of the KV heads that this rank's query heads attend,
    where ``wk`` / ``wv`` are replicated (KV does not divide ``model``):
    rank r holds query heads [h0, h1) of groups of G = H / KV."""
    h0, h1 = par.model.chunk(cfg.h_store)
    G = cfg.h_store // cfg.kv_store
    kv0, kv1 = h0 // G, (h1 - 1) // G + 1
    if (h1 - h0) % (kv1 - kv0):
        raise ValueError(f"{h1 - h0} query heads a rank do not group over "
                         f"{kv1 - kv0} KV heads")
    return kv0, kv1


def gqa_project_kv(x, p, cfg, positions, par=None):
    """The layer's keys and values (B, S, KV, hd), rotated.  ``par``:
    the tensor-parallel context where the query heads shard over
    ``model``; ``wk`` / ``wv`` then hold this rank's KV heads, or, where
    KV does not divide ``model``, all of them (each rank uses its own
    groups, so their gradients are summed over ``model``)."""
    wk, wv = p["wk"], p["wv"]
    if par is not None:
        x = par.copy_to_model(x)
        if not par.tp(cfg.kv_store):
            wk, wv = par.copy_to_model(wk), par.copy_to_model(wv)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
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


def _heads_out(out, p, cfg, par):
    """Attention output (B, S, H, dv) of this rank's heads -> (B, S, D):
    masked to the real heads, through ``wo`` (row-parallel under
    ``par``: all-reduced over ``model``)."""
    hm = local_head_mask(cfg, par)
    if hm is not None:
        out = out * hm.to(out.device, out.dtype)[None, None, :, None]
    # a bf16 cache under fp32 weights: promote, as jnp.einsum does
    wo = p["wo"]
    out = out.to(torch.promote_types(out.dtype, wo.dtype))
    y = torch.einsum("bshk,hkd->bsd", out, wo.to(out.dtype))
    return y if par is None else par.reduce_from_model(y)


def gqa_attend(x, p, cfg, *, k, v, q_pos, kv_pos, window=0, causal=True,
               par=None):
    """GQA attention of ``x``'s queries over ``k`` / ``v``, through
    ``wo``.  ``par``: as ``gqa_project_kv``'s; with all KV heads in
    ``k`` / ``v`` the rank attends its query heads' own groups."""
    if par is not None:
        x = par.copy_to_model(x)
        if not par.tp(cfg.kv_store):
            kv0, kv1 = kv_of_heads(cfg, par)
            k, v = k[:, :, kv0:kv1], v[:, :, kv0:kv1]
    q = gqa_query(x, p, cfg, q_pos)
    out = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
                    causal=causal)
    return _heads_out(out, p, cfg, par)


def gqa_attend_slots(x, p, cfg, *, k, v, q_pos, kv_pos, slots, window=0,
                     causal=True, heads=None):
    """GQA attention over a cache whose slots shard over ``model`` (the
    flash-decoding layout, where KV does not divide it): ``k`` / ``v``
    (B, T/m, KV, hd) hold every KV head of this rank's slots, at the
    absolute positions ``kv_pos``.  The queries of every head are
    gathered over ``model`` (``heads``: the tensor-parallel context where
    the query heads shard; None where each rank has them all); each rank
    takes every head's softmax over its slots, the maximum and the sum
    all-reduced (``slots``: the context of the slot sharding) before the
    probabilities are rounded, as the reference rounds them, and P.V
    summed in fp32; then each rank keeps its own heads.  The cache is
    never gathered."""
    q = gqa_query(x, p, cfg, q_pos)
    if heads is not None:
        q = heads.gather(q, 2, "model")
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) \
        * (1.0 / np.sqrt(dh))
    scores = torch.where(_mask(q_pos, kv_pos, window, causal), scores,
                         NEG_INF)
    mx = slots.max_over_model(scores.amax(dim=-1, keepdim=True))
    e = torch.exp(scores - mx)
    prob = e / slots.reduce_from_model(e.sum(dim=-1, keepdim=True))
    out = torch.einsum("bkgst,btkh->bskgh", prob.to(v.dtype).float(),
                       v.float())
    out = slots.reduce_from_model(out).to(v.dtype).reshape(
        B, S, H, v.shape[-1])
    if heads is not None:
        out = heads.shard(out, 2, "model")
    return _heads_out(out, p, cfg, heads)


# --------------------------------------------------------------- einsum ----
def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on the promoted dtype of its operands, as
    ``jnp.einsum`` promotes (a bf16 cache against fp32 weights)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt))


# ------------------------------------------------------------------ MoE ----
def moe_shapes(cfg) -> dict:
    """The MoE FFN's leaves: the fp32 router, the routed experts'
    stacked SwiGLU weights and, with shared experts, one MLP of
    ``n_shared_experts * moe_d_ff``."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    s = {"router": (D, E), "wg": (E, D, F), "wu": (E, D, F),
         "wd": (E, F, D)}
    if cfg.n_shared_experts:
        s["shared"] = mlp_shapes(D, cfg.n_shared_experts * F)
    return s


def moe_init(gen, cfg, dtype=torch.bfloat16) -> Params:
    """The router in fp32 and the experts in ``dtype``, all N(0, 0.02)."""
    def make(name, shape):
        if isinstance(shape, dict):
            return {n: make(n, s) for n, s in shape.items()}
        return dense_init(gen, shape, dtype=torch.float32
                          if name == "router" else dtype)
    return {name: make(name, shape)
            for name, shape in moe_shapes(cfg).items()}


class Routing(NamedTuple):
    """A grouped top-k routing: ``idx`` the experts (G, M, K), ``gates``
    their fp32 softmax weights, ``pos`` each slot's place in its
    expert's queue, ``keep`` whether that place is under the capacity
    ``C``, and ``margin`` (G, M) the k-th largest logit less the next
    (inf where k = E): how near the top-k set is to a tie."""
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    margin: torch.Tensor
    C: int


def moe_route(xg: torch.Tensor, router: torch.Tensor, cfg,
              idx: torch.Tensor | None = None) -> Routing:
    """The reference's routing of groups ``xg`` (G, M, D), exactly.

    The top k come from a stable descending sort, so equal logits go to
    the lower expert first, as ``jax.lax.top_k`` takes them (a zero pad
    row ties all E and goes to experts 0..K-1).  Queue places are
    slot-major: slot j of every token ranks before slot j+1 of any
    token, and within a slot the earlier token first.  ``idx`` (G, M,
    K), where given, is taken in place of the top k (a check replays
    another run's choices so), the gates then the softmax of those
    experts' logits.
    """
    return _routing(xg.float() @ router.float(), cfg, idx)


def route_groups(logits: torch.Tensor, cfg, idx: torch.Tensor | None = None,
                 first: int = 0) -> Routing:
    """``moe_route``'s routing of groups of fp32 router logits (G, M, E),
    where a mesh computes them (``moe_sharded``).  ``first``: the global
    index of the groups' first token, for a check that replays another
    run's routing token by token; the routing itself does not read it."""
    del first
    return _routing(logits, cfg, idx)


def _routing(logits: torch.Tensor, cfg, idx: torch.Tensor | None
             ) -> Routing:
    E, K = cfg.n_experts, cfg.experts_per_token
    G, M, _ = logits.shape
    top, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    margin = top[..., K - 1] - top[..., K] if K < E \
        else torch.full((G, M), math.inf, device=logits.device)
    if idx is None:
        top, idx = top[..., :K], order[..., :K]
    else:
        top = logits.gather(-1, idx)
    gates = torch.softmax(top, dim=-1)
    C = max(1, math.ceil(M * K * cfg.capacity_factor / E))
    slots = F.one_hot(idx.transpose(1, 2).reshape(G, K * M), E)  # slot-major
    before = torch.cumsum(slots, dim=1) - slots  # earlier slots per expert
    pos = before.gather(-1, idx.transpose(1, 2).reshape(G, K * M, 1))
    pos = pos.reshape(G, K, M).transpose(1, 2)  # (G, M, K)
    return Routing(idx, gates, pos, pos < C, margin, C)


def moe(x: torch.Tensor, p: Params, cfg, log: list | None = None,
        par=None, layout=None, batch_sharded: bool = True) -> torch.Tensor:
    """Top-k MoE with the reference's capacity-based routing.

    x: (B, S, D), in groups of ``moe_group_size`` tokens (the last padded
    with zero rows).  Where the reference multiplies by (G, M, E, C)
    one-hot dispatch and combine tensors, this gathers each kept (token,
    slot) into its expert's queue place, (G, E, C, D), and gathers the
    expert outputs back, weighted by the gates rounded to bf16 as the
    reference's combine is: the same function, without the one-hots.
    ``log``, when given, gets the routing of the real tokens: ``(idx,
    keep, margin)``, (B, S, K), (B, S, K) and (B, S) tensors.  ``par``,
    ``layout`` and ``batch_sharded``: on a mesh of more than one device,
    ``moe_sharded``'s.
    """
    if par is not None:
        return moe_sharded(x, p, cfg, log, par, layout, batch_sharded)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    N = B * S
    M = min(cfg.moe_group_size, N)
    xt = F.pad(x.reshape(N, D), (0, 0, 0, (-N) % M))
    G = xt.shape[0] // M
    xg = xt.reshape(G, M, D)
    r = moe_route(xg, p["router"], cfg)
    if log is not None:
        log.append((r.idx.reshape(-1, K)[:N].reshape(B, S, K),
                    r.keep.reshape(-1, K)[:N].reshape(B, S, K),
                    r.margin.reshape(-1)[:N].reshape(B, S)))
    C = r.C
    # each kept slot's queue place, E * C (a dump row) for a dropped one
    dest = torch.where(r.keep, r.idx * C + r.pos, E * C).reshape(G, M * K)
    token = torch.arange(M, device=x.device).repeat_interleave(K)
    src = torch.full((G, E * C + 1), M, dtype=torch.long, device=x.device)
    src.scatter_(1, dest, token.expand(G, -1))  # place -> token, M if empty
    xz = torch.cat([xg, xg.new_zeros(G, 1, D)], dim=1)
    xe = torch.gather(xz, 1, src[:, :E * C, None].expand(-1, -1, D))
    xe = xe.reshape(G, E, C, D)
    h = F.silu(_einsum("gecd,edf->gecf", xe, p["wg"])) \
        * _einsum("gecd,edf->gecf", xe, p["wu"])
    ye = _einsum("gecf,efd->gecd", h, p["wd"])
    yz = torch.cat([ye.reshape(G, E * C, D), ye.new_zeros(G, 1, D)], dim=1)
    yk = torch.gather(yz, 1, dest[..., None].expand(-1, -1, D))
    w = torch.where(r.keep, r.gates, 0.0).to(torch.bfloat16)
    y = torch.einsum("gmk,gmkd->gmd", w.float(),
                     yk.reshape(G, M, K, D).float()).to(ye.dtype)
    y = y.reshape(-1, D)[:N].reshape(B, S, D)
    if "shared" in p:
        y = y + mlp(x, p["shared"])
    return y.to(x.dtype)


def _touched_groups(n_local: int, d: int, M: int) -> int:
    """The most groups of M tokens that one of d ranks' n_local
    consecutive tokens reach into."""
    return max((r * n_local + n_local - 1) // M - (r * n_local) // M + 1
               for r in range(d))


def moe_sharded(x, p: Params, cfg, log, par, layout,
                batch_sharded: bool = True) -> torch.Tensor:
    """``moe`` on a mesh of more than one device, on this rank's tokens
    (B, S, D) and its shards of the weights: the same function.

    ``par``: this rank's place on the mesh (``collectives.Par``, also on
    a mesh whose ``model`` axis is 1).  ``layout``: the spec entries (E,
    D, F) of the routed experts' ``wg`` (``MeshRules.param_spec``
    without FSDP), given, never worked out here, so a caller can force
    either expert layout.  ``batch_sharded``: the tokens are this rank's
    share of the data plane's batch (else every data rank holds them
    all: a serve batch the plane does not divide).

    * Router: (D, E) with E over ``model`` where it divides; its fp32
      logits are gathered over ``model`` and the whole row sorted, so
      ties go to the lower expert as without a mesh.
    * Groups: the reference groups the global batch's tokens by
      ``moe_group_size``.  Where this rank's tokens are whole groups
      they are routed here; else a group spans data ranks (a decode
      step's tokens are one group) and the logits are gathered over the
      data plane, the whole groups routed (capacity and queue places
      from every rank's tokens), and each rank keeps its own rows; its
      gates come from its own logits.
    * Experts over ``model`` (E / m a rank): each rank fills and computes
      only its experts' queue places and weights their share of each
      token in fp32; the shares are summed over ``model`` (one
      all-reduce a layer, no all-to-all).
    * Experts over the data plane (F over ``model`` where it divides):
      each rank builds the (G, E, C, D) queue of its tokens, an
      all-to-all sends expert chunk j to data rank j, the rank computes
      (d, G, E/d, C, D) on its experts (its F slice: the output a share
      over ``model``), and a second all-to-all brings the outputs back
      to be combined.  Where the batch is not sharded, each data rank
      computes its experts for all the tokens and the shares are summed
      over the data plane (no gradient rule: a serve batch).
    * Experts whole: every rank computes them all.

    Under autograd the router's gradient is counted once: where a rank
    computes a share, the fp32 combine weights pass ``copy_to_model``,
    so their gradient is summed over ``model`` before it is rounded to
    bf16 (the rounding of the weights' cast, once, as without a mesh)
    and every rank holds the whole gradient of the gates; the logits'
    gather then keeps this rank's slice of it (``gather_whole``), and
    ``x`` reaches a router sharded over ``model`` through
    ``copy_to_model``.  The queues' all-to-all runs back in the
    backward, so each rank's expert gradients hold every data rank's
    tokens and are not summed over the data plane
    (``MeshRules.expert_parallel``).
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    e_entry, _, f_entry = layout
    data_ep = par.is_data(e_entry)
    dp = par.data if batch_sharded and par.data_size > 1 else None
    d, off = (dp.size, dp.rank) if dp is not None else (1, 0)
    N_l = B * S
    off *= N_l
    M = min(cfg.moe_group_size, N_l * d)
    share = par.model_size > 1 and "model" in (e_entry, f_entry)

    # the router's logits, whole rows
    xt = x.reshape(N_l, D)
    xin = par.copy_to_model(xt) if share else xt
    router = p["router"]
    if router.shape[-1] < E:  # E over model
        xr = xin if share else par.copy_to_model(xt)
        logits = par.gather_whole(xr.float() @ router.float(), -1, "model")
    else:
        logits = xt.float() @ router.float()

    # the routing of this rank's tokens, in the reference's groups
    if N_l % M:  # a group spans data ranks: route the whole groups
        with torch.no_grad():
            full = logits.detach()
            if dp is not None:
                full = par.gather(full, 0, par.data_axes)
            full = F.pad(full, (0, 0, 0, (-full.shape[0]) % M))
            r = route_groups(full.reshape(-1, M, E), cfg)
        rows = slice(off, off + N_l)
        idx, pos, keep = (t.reshape(-1, K)[rows] for t in (r.idx, r.pos,
                                                             r.keep))
        margin = r.margin.reshape(-1)[rows]
        gates = torch.softmax(logits.gather(-1, idx), dim=-1)
        Gt = _touched_groups(N_l, d, M)
        group = (off + torch.arange(N_l, device=x.device)) // M - off // M
    else:
        r = route_groups(logits.reshape(-1, M, E), cfg, first=off)
        idx, pos, keep, gates = (t.reshape(-1, K) for t in (
            r.idx, r.pos, r.keep, r.gates))
        margin = r.margin.reshape(-1)
        Gt = N_l // M
        group = torch.arange(N_l, device=x.device) // M
    if log is not None:
        log.append((idx.reshape(B, S, K), keep.reshape(B, S, K),
                    margin.reshape(B, S)))
    C = r.C

    # this rank's queue places: its experts', of its tokens
    e0, e1 = 0, E
    if e_entry == "model" and par.model_size > 1:
        e0, e1 = par.model.chunk(E)
    elif data_ep and dp is None and par.data_size > 1:
        e0, e1 = par.data.chunk(E)
    Eq = e1 - e0
    places = Gt * Eq * C
    mine = keep & (idx >= e0) & (idx < e1)
    dest = torch.where(mine, (group[:, None] * Eq + idx - e0) * C + pos,
                       places)  # (N_l, K); ``places``: a dump row
    src = torch.full((places + 1,), N_l, dtype=torch.long, device=x.device)
    src.scatter_(0, dest.reshape(-1), torch.arange(
        N_l, device=x.device).repeat_interleave(K))  # place -> token
    xz = torch.cat([xin, xin.new_zeros(1, D)])
    xe = xz.index_select(0, src[:places]).reshape(Gt, Eq, C, D)
    if data_ep and dp is not None:  # expert chunk j to data rank j
        xe = par.exchange_chunks(xe.reshape(Gt, d, E // d, C, D)
                                 .transpose(0, 1), e_entry)
    h = F.silu(_einsum("...ecd,edf->...ecf", xe, p["wg"])) \
        * _einsum("...ecd,edf->...ecf", xe, p["wu"])
    ye = _einsum("...ecf,efd->...ecd", h, p["wd"])
    if data_ep and dp is not None:  # the outputs back to their tokens
        ye = par.exchange_chunks(ye, e_entry).transpose(0, 1)
    yz = torch.cat([ye.reshape(places, D), ye.new_zeros(1, D)])
    yk = yz.index_select(0, dest.reshape(-1)).reshape(N_l, K, D)
    w = torch.where(keep, gates, 0.0).to(torch.bfloat16).float()
    if share:  # the combine weights' gradient summed before its bf16 round
        w = par.copy_to_model(w)
    y = torch.einsum("nk,nkd->nd", w, yk.float())
    if share:
        y = par.reduce_from_model(y)
    if data_ep and dp is None:
        y = par.sum_over(y, e_entry)
    y = y.to(ye.dtype).reshape(B, S, D)
    if "shared" in p:
        n = cfg.n_shared_experts * cfg.moe_d_ff
        y = y + mlp(x, p["shared"], par=par if par.tp(n) else None)
    return y.to(x.dtype)


# ---------------------------------------------------------------- MLA ------
def mla_shapes(cfg) -> dict:
    """MLA's leaves; ``kv_norm`` and ``q_norm`` are the fp32 norm
    weights.  ``q_lora_rank`` 0 projects the queries with one ``wq``."""
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    s = {"wdkv": (D, kvr), "kv_norm": (kvr,), "wuk": (kvr, H, dn),
         "wuv": (kvr, H, dv), "wkr": (D, dr), "wo": (H, dv, D)}
    if qr:
        s.update(wdq=(D, qr), q_norm=(qr,), wuq=(qr, H, dn + dr))
    else:
        s["wq"] = (D, H, dn + dr)
    return s


MLA_NORMS = ("kv_norm", "q_norm")


def mla_init(gen, cfg, dtype=torch.bfloat16) -> Params:
    return {name: torch.zeros(shape, device=gen.device)
            if name in MLA_NORMS else dense_init(gen, shape, dtype=dtype)
            for name, shape in mla_shapes(cfg).items()}


def mla_queries(x, p, cfg, positions, par=None):
    """(q_nope, q_rope): the no-position and the rotated query parts.
    ``par``: the tensor-parallel context where the heads shard over
    ``model``: ``wdq`` and ``q_norm`` are whole on every rank, and their
    output reaches this rank's heads of ``wuq`` through
    ``copy_to_model`` (so their gradients, and ``x``'s, are whole)."""
    dn = cfg.qk_nope_head_dim
    if "wdq" in p:
        qc = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
        if par is not None:
            qc = par.copy_to_model(qc)
        q = _einsum("bsr,rhk->bshk", qc, p["wuq"])
    else:
        q = _einsum("bsd,dhk->bshk",
                    x if par is None else par.copy_to_model(x), p["wq"])
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def mla_latent(x, p, cfg, positions):
    """Per-token latent cache entries: (c_kv (B, S, kvr), k_rope (B, S,
    dr)), whole on every rank of a mesh."""
    c = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    kr = rope((x @ p["wkr"])[:, :, None, :], positions, cfg.rope_theta)
    return c, kr[:, :, 0, :]


def mla_attend_naive(x, p, cfg, *, c, k_rope, q_pos, kv_pos, par=None):
    """Train/prefill path: the latent expanded to per-head K/V, then
    attention with q/k head dim dn + dr and v head dim dv.  ``par``: the
    tensor-parallel context where the heads shard over ``model``: this
    rank's heads attend (``c`` and ``k_rope`` reach them through
    ``copy_to_model``) and ``wo`` is row-parallel (all-reduced)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = mla_queries(x, p, cfg, q_pos, par)
    if par is not None:
        c, k_rope = par.copy_to_model(c), par.copy_to_model(k_rope)
    k_nope = _einsum("btr,rhk->bthk", c, p["wuk"])
    v = _einsum("btr,rhk->bthk", c, p["wuv"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].to(k_nope.dtype).expand(
        *k_nope.shape[:3], dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                    scale=1.0 / np.sqrt(dn + dr))
    y = _einsum("bshk,hkd->bsd", out, p["wo"])
    return y if par is None else par.reduce_from_model(y)


def mla_attend_absorbed(x, p, cfg, *, c, k_rope, q_pos, kv_pos, slots=None,
                        heads=None):
    """Decode path: the queries absorbed into the latent space, attending
    to the compressed (kv_lora + rope) cache itself.  The reference's
    dtypes: ``q_c`` in the activations' dtype, fp32 scores, the
    probabilities rounded to the cache's dtype, ``ctx`` in it.

    On a mesh, ``slots``: the context where the cache's slots shard over
    ``model`` (``c`` / ``k_rope`` (B, T/m, ...) at the positions
    ``kv_pos``), as ``gqa_attend_slots`` attends a GQA cache: the
    absorbed queries of every head gathered over ``model`` (``heads``:
    the context where the heads shard; None where each rank has them
    all), fp32 scores over this rank's slots, the maximum and the sum
    all-reduced, the probabilities rounded to the cache's dtype, ``ctx``
    (B, S, H, r) summed over ``model`` in fp32; then each rank keeps its
    own heads for ``wuv`` and the row-parallel ``wo``."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = mla_queries(x, p, cfg, q_pos)
    q_c = _einsum("bshn,rhn->bshr", q_nope, p["wuk"])  # absorb W_uk
    if heads is not None:
        q_c, q_rope = heads.gather(q_c, 2, "model"), \
            heads.gather(q_rope, 2, "model")
    scores = (torch.einsum("bshr,btr->bhst", q_c.float(), c.float())
              + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             k_rope.float()))
    scores = scores / np.sqrt(dn + dr)
    mask = _mask(q_pos, kv_pos, 0, True)
    scores = torch.where(mask, scores, NEG_INF)
    if slots is None:
        ctx = _pv(torch.softmax(scores, dim=-1), c, "bhst,btr->bshr")
    else:
        mx = slots.max_over_model(scores.amax(dim=-1, keepdim=True))
        e = torch.exp(scores - mx)
        prob = e / slots.reduce_from_model(e.sum(dim=-1, keepdim=True))
        ctx = torch.einsum("bhst,btr->bshr", prob.to(c.dtype).float(),
                           c.float())
        ctx = slots.reduce_from_model(ctx).to(c.dtype)
    if heads is not None:
        ctx = heads.shard(ctx, 2, "model")
    out = _einsum("bshr,rhk->bshk", ctx, p["wuv"])  # expand with W_uv
    y = _einsum("bshk,hkd->bsd", out, p["wo"])
    return y if heads is None else heads.reduce_from_model(y)


# ---------------------------------------------------------------- Mamba ----
# fp32 leaves of the Mamba block with a rule of their own (the rest of its
# fp32 leaves, ``conv_b``, start at 0 as the norms do)
MAMBA_DRAWN = {"conv_w": 0.1, "dt_proj": 0.1}  # N(0, scale), fp32
DT_BIAS = -4.6  # softplus^-1(0.01)


def init_leaf(gen: torch.Generator, path: tuple, spec) -> torch.Tensor:
    """The reference's init of one parameter leaf (``spec``: its shape
    and dtype; layer-stacked or not), by the leaf's name: bf16 weights
    and the fp32 MoE router N(0, 0.02); Mamba's ``conv_w`` and
    ``dt_proj`` N(0, 0.1), ``A_log`` log(1..N) over the state axis,
    ``dt_bias`` -4.6 and ``D_skip`` 1; every other fp32 leaf (the norms,
    which scale by ``1 + w``, and ``conv_b``) 0."""
    name, shape, dev = path[-1], tuple(spec.shape), gen.device
    if spec.dtype != torch.float32 or name == "router":
        return dense_init(gen, shape, dtype=spec.dtype)
    if name in MAMBA_DRAWN:
        return dense_init(gen, shape, scale=MAMBA_DRAWN[name],
                          dtype=torch.float32)
    if name == "A_log":  # numpy's fp32 log gives the reference's bits
        a = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32))
        return torch.from_numpy(a).to(dev).expand(shape).contiguous()
    if name == "dt_bias":
        return torch.full(shape, DT_BIAS, device=dev)
    if name == "D_skip":
        return torch.ones(shape, device=dev)
    return torch.zeros(shape, device=dev)


def mamba_shapes(cfg) -> dict:
    """The Mamba-1 block's leaves: the bf16 projections, and in fp32 the
    depthwise conv, the dt projection and bias, ``A_log`` and the skip."""
    D, Di, N, K, R = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                      cfg.dt_rank)
    return {"in_proj": (D, 2 * Di), "conv_w": (K, Di), "conv_b": (Di,),
            "x_proj": (Di, R + 2 * N), "dt_proj": (R, Di), "dt_bias": (Di,),
            "A_log": (Di, N), "D_skip": (Di,), "out_proj": (Di, D)}


MAMBA_FP32 = ("conv_w", "conv_b", "dt_proj", "dt_bias", "A_log", "D_skip")


def mamba_init(gen, cfg, dtype=torch.bfloat16) -> Params:
    return {name: init_leaf(gen, (name,), Spec(
        shape, torch.float32 if name in MAMBA_FP32 else dtype))
        for name, shape in mamba_shapes(cfg).items()}


def _mamba_inputs(x, p, cfg, conv_state=None, par=None):
    """Shared projections.  Returns (x_conv, z, dt, Bp, Cp,
    new_conv_state).  The causal depthwise conv runs in fp32 over the
    history in ``x``'s dtype: a decode step's fp32 conv state is rounded
    to it first, as the reference rounds it.  ``par``: the
    tensor-parallel context where d_inner shards over ``model``: the
    ``in_proj`` output is exchanged so that each rank holds x and z of
    its own d_inner chunk (``Par.exchange_halves``), ``x_proj`` is
    row-parallel (its output all-reduced, then used whole by every
    rank), and the rest is this rank's channels."""
    K = cfg.ssm_conv
    if par is None:
        xz = x @ p["in_proj"]
    else:
        xz = par.exchange_halves(par.copy_to_model(x) @ p["in_proj"])
    x_in, z = torch.chunk(xz, 2, dim=-1)  # (B, S, Di)
    if conv_state is None:
        hist = F.pad(x_in, (0, 0, K - 1, 0))
    else:
        hist = torch.cat([conv_state.to(x_in.dtype), x_in], dim=1)
    new_conv_state = hist[:, hist.shape[1] - (K - 1):].float()
    xf = hist.float()
    S = x_in.shape[1]
    conv = sum(xf[:, j:j + S] * p["conv_w"][j] for j in range(K)) \
        + p["conv_b"]
    x_conv = F.silu(conv).to(x.dtype)

    R, N = cfg.dt_rank, cfg.ssm_state
    dbc = x_conv @ p["x_proj"]
    if par is not None:
        dbc = par.copy_to_model(par.reduce_from_model(dbc))
    dt_r, Bp, Cp = torch.split(dbc, [R, N, N], dim=-1)
    # fp32, as jnp's matmul promotes a bf16 ``dt_proj`` (a train step's
    # new parameters are bf16)
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float() + p["dt_bias"])
    return x_conv, z, dt, Bp.float(), Cp.float(), new_conv_state


def _mamba_out(y, p, par):
    """The gated scan output through ``out_proj`` (row-parallel under
    ``par``: all-reduced over ``model``)."""
    y = y @ p["out_proj"]
    return y if par is None else par.reduce_from_model(y)


def _scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 (from h = 0):
    (the products of a, the b part).  Hillis-Steele, log2(c) steps, each
    the reference's combine ``(l0 r0, r0 l1 + r1)`` of every element with
    the one ``d`` before it."""
    d = 1
    while d < a.shape[1]:
        b_new = b.clone()
        b_new[:, d:].addcmul_(a[:, d:], b[:, :-d])
        a_new = a.clone()
        a_new[:, d:].mul_(a[:, :-d])
        a, b = a_new, b_new
        d *= 2
    return a, b


def mamba_scan(x, p, cfg, h0=None, conv_state=None, par=None):
    """Chunked selective scan.  x: (B, S, D) -> (y, h_final, conv_tail).

    A loop over chunks of ``SSM_CHUNK`` tokens carries the fp32 state
    ``h`` (B, Di, N); within a chunk a log-step scan runs on the bounded
    (B, c, Di, N) transient, in ``cfg.ssm_compute_dtype``.  The reference
    pads the last chunk with zeros after the softplus (a = 1, b = 0: the
    state holds); here the last chunk is simply shorter, which gives the
    same state.  ``par``: as ``_mamba_inputs``'s (the state then holds
    this rank's Di / m channels).
    """
    B, S, _ = x.shape
    x_conv, z, dt, Bp, Cp, conv_tail = _mamba_inputs(x, p, cfg, conv_state,
                                                     par)
    Di, N = x_conv.shape[-1], cfg.ssm_state
    A = -torch.exp(p["A_log"])  # (Di, N)
    cdt = torch.bfloat16 if cfg.ssm_compute_dtype == "bf16" \
        else torch.float32
    h = torch.zeros((B, Di, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    c = min(SSM_CHUNK, S)
    ys = []
    for s0 in range(0, S, c):
        dtc, xc = dt[:, s0:s0 + c], x_conv[:, s0:s0 + c].float()
        a = torch.exp(dtc[..., None] * A).to(cdt)  # (B, c, Di, N)
        b = ((dtc * xc)[..., None] * Bp[:, s0:s0 + c, None, :]).to(cdt)
        a_sc, b_sc = _scan_chunk(a, b)
        hs = a_sc * h[:, None].to(cdt) + b_sc
        ys.append(torch.einsum("bcdn,bcn->bcd", hs.float(),
                               Cp[:, s0:s0 + c].to(cdt).float()))
        h = hs[:, -1].float()
        del a, b, a_sc, b_sc, hs
    y = torch.cat(ys, dim=1) + p["D_skip"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return _mamba_out(y, p, par), h, conv_tail


def mamba_step(x, p, cfg, h, conv_state, par=None):
    """Single-token decode.  x: (B, 1, D); h: (B, Di, N) fp32;
    conv_state: (B, K-1, Di) fp32.  Returns (y, h_new, conv_state_new).
    ``par``: as ``_mamba_inputs``'s."""
    x_conv, z, dt, Bp, Cp, new_conv = _mamba_inputs(x, p, cfg, conv_state,
                                                    par)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[:, 0, :, None] * A)  # (B, Di, N)
    b = (dt[:, 0] * x_conv[:, 0].float())[..., None] * Bp[:, 0, None, :]
    h_new = a * h + b
    y = torch.einsum("bdn,bn->bd", h_new, Cp[:, 0])[:, None, :]
    y = y + p["D_skip"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return _mamba_out(y, p, par), h_new, new_conv
