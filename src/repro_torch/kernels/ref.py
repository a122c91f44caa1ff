"""Plain torch versions of every CUDA kernel in this package.

These are the semantics contracts, ports of the JAX reference's
``repro.kernels.ref`` oracles: each kernel wrapper takes its plain
version for a tensor that lies on the CPU, the CPU tests hold them
against the reference, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.

All uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF``: torch on the
CPU has no ``<<`` for ``torch.uint32``.  A uint32 result is returned as
an int32 tensor holding the same bits (view it as ``np.uint32`` on the
host), the form the CUDA kernels write too.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chunking import GEAR_TABLE, WINDOW
from repro_torch.core.gf256 import GF_EXP, GF_LOG
from repro_torch.core.hashing import SHA1_H0, SHA1_K

M32 = 0xFFFFFFFF


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def u32_values(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any ints) -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


# ---------------------------------------------------------------------------
# GF(256) matmul (Reed-Solomon encode/decode)
# ---------------------------------------------------------------------------

def gf_matmul_ref(M, D: torch.Tensor, gf_log: torch.Tensor | None = None,
                  gf_exp: torch.Tensor | None = None) -> torch.Tensor:
    """GF(256) matrix product via log/exp tables.

    M: (r, k) uint8/int coding matrix (tensor or numpy).
    D: (..., k, L) uint8 data pieces.
    returns (..., r, L) uint8 on D's device.
    """
    dev = D.device
    log = (torch.from_numpy(GF_LOG.astype(np.int64)) if gf_log is None
           else gf_log).to(dev, torch.int64)
    exp = (torch.from_numpy(GF_EXP.astype(np.int64)) if gf_exp is None
           else gf_exp).to(dev, torch.int64)
    M = torch.as_tensor(M).to(dev, torch.int64)
    D = D.to(torch.int64)
    r, k = M.shape
    out = torch.zeros(D.shape[:-2] + (r, D.shape[-1]), dtype=torch.int64,
                      device=dev)
    for j in range(k):
        m = M[:, j].reshape((1,) * (D.dim() - 2) + (r, 1))
        d = D[..., j: j + 1, :]
        prod = exp[log[m] + log[d]]
        prod = torch.where((m == 0) | (d == 0), 0, prod)
        out = out ^ prod
    return out.to(torch.uint8)


# ---------------------------------------------------------------------------
# Gear CDC rolling hash
# ---------------------------------------------------------------------------

def gear_hash_ref(data: torch.Tensor,
                  gear: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) uint8 -> (N,) gear hash (32-tap weighted sum), as int32 bits.

    History before position 0 contributes 0 (the pad comes after the
    table lookup, not ``gear[0]``).
    """
    table = (torch.from_numpy(GEAR_TABLE.astype(np.int64)) if gear is None
             else u32_values(gear)).to(data.device, torch.int64)
    g = table[data.to(torch.int64)]
    n = g.shape[0]
    h = torch.zeros_like(g)
    for j in range(min(WINDOW, n)):
        shifted = torch.nn.functional.pad(g[: n - j], (j, 0)) << j
        h = (h + shifted) & M32
    return u32_bits(h)


# ---------------------------------------------------------------------------
# SHA-1 (batched, padded-block input)
# ---------------------------------------------------------------------------

_H0 = SHA1_H0.astype(np.int64)
_K = SHA1_K.astype(np.int64)


def _scalars(device: torch.device) -> dict[str, torch.Tensor]:
    """The round constants as 0-dim tensors: torch dispatches a Python
    scalar operand about twice as slowly as a tensor one, and on the CPU
    this version's time is all dispatch."""
    vals = {"m32": M32, "k0": _K[0], "k1": _K[1], "k2": _K[2], "k3": _K[3]}
    vals.update({f"s{c}": c for c in (1, 2, 5, 27, 30, 31)})
    return {n: torch.tensor(int(v), dtype=torch.int64, device=device)
            for n, v in vals.items()}


def _rotl(x: torch.Tensor, c: int, s: dict[str, torch.Tensor]
          ) -> torch.Tensor:
    return ((x << s[f"s{c}"]) | (x >> s[f"s{32 - c}"])) & s["m32"]


def _sha1_block(h: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One SHA-1 compression. h: (..., 5), words: (..., 16), int64 values.

    Written for few torch ops, since the CPU tests run it for every
    chunk id: the schedule grows three words per step (w[t..t+2] need
    only w[<t]), and each round masks its sum once -- ``rotl(a, 5)``
    feeds only that sum, so its high bits need no mask of their own.
    """
    s = _scalars(words.device)
    w = torch.empty(words.shape[:-1] + (80,), dtype=torch.int64,
                    device=words.device)
    w[..., :16] = words
    for t in range(16, 80, 3):
        x = (w[..., t - 3:t] ^ w[..., t - 8:t - 5] ^ w[..., t - 14:t - 11]
             ^ w[..., t - 16:t - 13])
        w[..., t:t + 3] = _rotl(x, 1, s)[..., : 80 - t]
    a, b, c, d, e = (h[..., i] for i in range(5))
    for t in range(80):
        if t < 20:
            f, k = d ^ (b & (c ^ d)), s["k0"]
        elif t < 40:
            f, k = b ^ c ^ d, s["k1"]
        elif t < 60:
            f, k = (b & c) | (d & (b | c)), s["k2"]
        else:
            f, k = b ^ c ^ d, s["k3"]
        tmp = ((a << s["s5"]) + (a >> s["s27"]) + f + e + w[..., t] + k) \
            & s["m32"]
        e, d, c, b, a = d, c, _rotl(b, 30, s), a, tmp
    return (h + torch.stack([a, b, c, d, e], dim=-1)) & s["m32"]


def _sha1_words_loop(blocks: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Loop over the block axis; lanes past their real count keep h."""
    B, M, _ = blocks.shape
    h = torch.tensor(_H0, device=blocks.device).expand(B, 5)
    for m in range(M):
        upd = _sha1_block(h, blocks[:, m, :])
        h = torch.where((m < counts)[:, None], upd, h)
    return h


def sha1_ref(blocks: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Batched SHA-1 over padded message blocks.

    blocks: (B, M, 16) big-endian word values (int32 bits or int64).
    counts: (B,) number of real blocks per message.
    returns (B, 5) digest words as int32 bits.
    """
    words = _sha1_words_loop(u32_values(blocks),
                             counts.to(blocks.device, torch.int64).reshape(-1))
    return u32_bits(words)


# ---------------------------------------------------------------------------
# Fused ingest: SHA-1 ids and GF encode of one piece-length bucket
# ---------------------------------------------------------------------------

def _sha1_pad_packed(data: torch.Tensor, nbytes: torch.Tensor,
                     piece_lens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SHA-1 message blocks of chunks packed as ``rs_code.pack_blob`` lays
    them out, padded as ``hashing.sha1_pad_blocks`` pads a message.

    data: (B, k, Lp) uint8; message byte i of row b sits at
    ``data[b, i // L_b, i % L_b]`` with ``L_b = piece_lens[b]``.
    nbytes, piece_lens: (B,) message lengths and piece lengths (clamped
    to the slab, as the kernel clamps them).
    returns ((B, Mb, 16) big-endian word values as int64, (B,) real block
    counts), Mb the largest count.
    """
    B, k, Lp = data.shape
    dev = data.device
    L = piece_lens.to(dev, torch.int64).reshape(-1).clamp(1, Lp)
    n = torch.minimum(nbytes.to(dev, torch.int64).reshape(-1).clamp(min=0),
                      k * L)
    counts = (n + 8) // 64 + 1
    Mb = int(counts.max()) if B else 1
    i = torch.arange(Mb * 64, device=dev)[None, :]
    inside = i < n[:, None]
    src = torch.where(inside, (i // L[:, None]) * Lp + i % L[:, None], 0)
    msg = torch.gather(data.reshape(B, k * Lp).to(torch.int64), 1, src)
    msg = torch.where(inside, msg, 0)
    msg = torch.where(i == n[:, None], 0x80, msg)
    # the bit length, big-endian, in the last 8 bytes of the last block
    bits = n * 8
    last = counts * 64 - 8
    for t in range(8):
        msg.scatter_(1, (last + t)[:, None],
                     ((bits >> (8 * (7 - t))) & 0xFF)[:, None])
    b4 = msg.reshape(B, Mb, 16, 4)
    words = (b4[..., 0] << 24) | (b4[..., 1] << 16) | (b4[..., 2] << 8) \
        | b4[..., 3]
    return words, counts


def fused_ingest_ref(G, data: torch.Tensor, nbytes: torch.Tensor,
                     piece_lens: torch.Tensor,
                     gf_log: torch.Tensor | None = None,
                     gf_exp: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """SHA-1 chunk ids and RS code pieces of one packed bucket.

    G: (n, k) generator matrix; data: (B, k, Lp) uint8 packed chunks;
    nbytes, piece_lens: (B,) each chunk's length and piece length.
    returns ((B, 5) digest words as int32 bits, (B, n, Lp) uint8 pieces).
    """
    blocks, counts = _sha1_pad_packed(data, nbytes, piece_lens)
    return sha1_ref(blocks, counts), gf_matmul_ref(G, data, gf_log, gf_exp)


# ---------------------------------------------------------------------------
# Flash attention (GQA, causal / sliding window), in the model's layout
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # the reference's mask value: a fully masked row stays finite
# query rows per step of the plain version: bounds its (rows, T) scores,
# 537 MB of fp32 at 32 heads and T = 8192
FLASH_Q_CHUNK = 512


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """What ``repro/kernels/flash_attn.py``'s kernel computes.

    q: (B, S, H, hd); k, v: (B, T, KV, hd) with H a multiple of KV (query
    head h reads KV head h // (H // KV)).  The queries are the last S of
    the T positions (``q_offset = T - S``).  Masks, as the kernel applies
    them: keys past T (none here: nothing is padded), then causal
    (``k <= q``), then the window (``k > q - window``, with or without
    causal).  Scores and softmax in fp32 with masked scores at
    ``NEG_INF``; the unnormalised p is rounded to v's dtype before P.V,
    and the row sum takes p before rounding.  Rows run in chunks of
    ``FLASH_Q_CHUNK`` so a long S keeps its (S, T) scores bounded.
    returns (B, S, H, hd) in q's dtype.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale or (1.0 / np.sqrt(hd))
    dev = q.device
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(T, device=dev)
    out = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=dev)
    for s0 in range(0, S, FLASH_Q_CHUNK):
        s1 = min(S, s0 + FLASH_Q_CHUNK)
        qg = q[:, s0:s1].float().reshape(B, s1 - s0, KV, G, hd)
        s = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
        q_pos = (T - S) + torch.arange(s0, s1, device=dev)
        mask = torch.ones((s1 - s0, T), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1).clamp_min(1e-30)  # (B, KV, G, s)
        acc = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).float(), vf)
        o = acc / denom.permute(0, 3, 1, 2)[..., None]
        out[:, s0:s1] = o.reshape(B, s1 - s0, H, -1).to(q.dtype)
    return out
