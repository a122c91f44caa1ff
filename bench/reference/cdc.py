"""Gear content-defined chunking: the boundary rule, in plain NumPy.

The gear hash ``h_t = 2 h_{t-1} + gear[b_t] (mod 2^32)`` over a file's
own bytes (zero history at its first byte) equals the 32-tap sum
``sum_j 2^j gear[b_{t-j}]``.  A position fires where the hash's top
``log2(avg)`` bits are zero, and the cut falls after that byte.  Cuts are
chosen greedily: the first firing position at least ``min`` bytes past
the last cut and at most ``max`` past it, else ``max`` past it; a tail of
``min`` bytes or less is one chunk.
"""

from __future__ import annotations

import numpy as np

GEAR_SEED = 0x5EA125
WINDOW = 32
GEAR_TABLE = np.random.RandomState(GEAR_SEED).randint(
    0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)


def gear_hash(data: np.ndarray) -> np.ndarray:
    """(N,) uint8 -> (N,) uint32 gear hash of every position."""
    g = GEAR_TABLE[np.asarray(data, dtype=np.uint8)]
    h = np.zeros(g.shape[0], dtype=np.uint32)
    for j in range(min(WINDOW, g.shape[0])):
        h[j:] += g[: g.shape[0] - j] << np.uint32(j)
    return h


def mask(avg: int) -> int:
    bits = int(avg).bit_length() - 1
    return ((1 << bits) - 1) << (32 - bits)


def boundaries(data: bytes, min_size: int, avg_size: int,
               max_size: int) -> list[int]:
    """Cut offsets (exclusive ends) of ``data``'s chunks; the last is len."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.shape[0]
    if n == 0:
        return []
    fire = np.flatnonzero((gear_hash(arr) & np.uint32(mask(avg_size))) == 0)
    fire = fire.astype(np.int64) + 1
    cuts, start = [], 0
    while start < n:
        if n - start <= min_size:
            cut = n
        else:
            end = min(start + max_size, n)
            i = int(np.searchsorted(fire, start + min_size, side="left"))
            cut = int(fire[i]) if i < fire.shape[0] and fire[i] <= end \
                else end
        cuts.append(cut)
        start = cut
    return cuts


def lengths(data: bytes, min_size: int, avg_size: int,
            max_size: int) -> list[int]:
    """Chunk lengths of ``data``, in order."""
    prev, out = 0, []
    for c in boundaries(data, min_size, avg_size, max_size):
        out.append(c - prev)
        prev = c
    return out
