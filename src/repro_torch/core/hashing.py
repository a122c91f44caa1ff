"""Chunk identifiers.

Default (paper-faithful): 160-bit SHA-1.  The host storage path uses
``hashlib`` (exact, C-speed); the device path is the batched SHA-1 CUDA
kernel in ``repro_torch.kernels.sha1`` validated against ``hashlib``.
This module holds the shared message-schedule preprocessing plus a fast
non-cryptographic 128-bit id for trusted deployments.
"""

from __future__ import annotations

import hashlib

import numpy as np

SHA1_H0 = np.array(
    [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0],
    dtype=np.uint32)
SHA1_K = np.array(
    [0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6], dtype=np.uint32)


def chunk_id(data: bytes) -> bytes:
    """Paper-faithful 160-bit SHA-1 chunk id (host path)."""
    return hashlib.sha1(data).digest()


def fast_chunk_id(data: bytes) -> bytes:
    """Non-cryptographic 128-bit id (blake2b-128) for trusted settings."""
    return hashlib.blake2b(data, digest_size=16).digest()


def sha1_pad_blocks(data: bytes) -> np.ndarray:
    """SHA-1 message padding -> (n_blocks, 16) uint32 big-endian words."""
    n = len(data)
    pad_len = (55 - n) % 64  # bytes of zero padding after the 0x80 byte
    buf = data + b"\x80" + b"\x00" * pad_len + (8 * n).to_bytes(8, "big")
    words = np.frombuffer(buf, dtype=">u4").astype(np.uint32)
    return words.reshape(-1, 16)


def sha1_pad_batch(chunks: list[bytes], max_len: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a batch of chunks to a common block count.

    Returns ``(blocks, n_blocks)`` where ``blocks`` is
    (B, max_blocks, 16) uint32 and ``n_blocks`` (B,) int32 gives the number
    of *real* blocks per chunk (trailing blocks are zero and must be
    ignored by the compression loop).

    ``max_len`` (message bytes) is an *authoritative* cap on the block
    axis: a chunk that would not fit raises ``ValueError`` instead of
    silently widening the compiled launch shape (callers route such
    chunks to a host hash fallback).  Under the cap the block axis is
    *bucketed* -- padded to the next power of two of the batch's own
    need, clamped to the cap -- so callers see a bounded set of compiled
    shapes ({1, 2, 4, ..., cap} blocks) instead of always paying the
    worst-case width.  A window of 4 KB-average chunks used to drag a
    129-block (8 KB-cap) message schedule through the compression loop
    for every lane; bucketing cuts that steady-state overhead without
    reopening the per-window retrace bug the fixed cap solved.
    """
    padded = [sha1_pad_blocks(c) for c in chunks]
    counts = np.array([p.shape[0] for p in padded], dtype=np.int32)
    cap = max(int(counts.max()), 1)
    if max_len is not None:
        fixed = (max_len + 9 + 63) // 64
        if cap > fixed:
            raise ValueError(
                f"chunk needs {cap} SHA-1 blocks > fixed cap {fixed} "
                f"(max_len={max_len}); hash oversized chunks on the host")
        cap = min(1 << (cap - 1).bit_length(), fixed)
    out = np.zeros((len(chunks), cap, 16), dtype=np.uint32)
    for i, p in enumerate(padded):
        out[i, : p.shape[0]] = p
    return out, counts


def digest_words_to_bytes(words: np.ndarray) -> list[bytes]:
    """(B, 5) uint32 big-endian digest words -> list of 20-byte digests."""
    words = np.asarray(words, dtype=np.uint32)
    be = words.astype(">u4")
    return [be[i].tobytes() for i in range(be.shape[0])]


def sha1_np(data: bytes) -> bytes:
    """Pure-numpy single-message SHA-1 (used as an independent cross-check)."""
    blocks = sha1_pad_blocks(data)
    h = SHA1_H0.copy()

    def rotl(x, c):
        x = np.uint32(x)
        return np.uint32((np.uint64(x) << np.uint64(c) | (np.uint64(x) >> np.uint64(32 - c))) & 0xFFFFFFFF)

    for blk in blocks:
        w = list(blk)
        for t in range(16, 80):
            w.append(rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
        a, b, c, d, e = h
        for t in range(80):
            if t < 20:
                f, k = (b & c) | (~b & d), SHA1_K[0]
            elif t < 40:
                f, k = b ^ c ^ d, SHA1_K[1]
            elif t < 60:
                f, k = (b & c) | (b & d) | (c & d), SHA1_K[2]
            else:
                f, k = b ^ c ^ d, SHA1_K[3]
            tmp = np.uint32(
                (np.uint64(rotl(a, 5)) + np.uint64(f) + np.uint64(e)
                 + np.uint64(k) + np.uint64(w[t])) & 0xFFFFFFFF)
            e, d, c, b, a = d, c, rotl(b, 30), a, tmp
        h = np.uint32((h.astype(np.uint64) + np.array([a, b, c, d, e], np.uint64)) & 0xFFFFFFFF)
    return h.astype(">u4").tobytes()
