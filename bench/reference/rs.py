"""Systematic Reed-Solomon (n, k) over GF(2^8), in plain NumPy.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) with generator 2.
The generator matrix is ``[I_k ; P]`` with the Cauchy block
``P[i, j] = 1 / (x_i + y_j)``, ``x = k .. n-1``, ``y = 0 .. k-1``, so any
k of its rows are invertible.  A blob of ``nbytes`` is zero-padded to
``k * L`` bytes, ``L = max(1, ceil(nbytes / k))``, and laid out as k rows
of L; piece i is row i of ``G @ rows``.  Decoding takes the k lowest
indices received and applies the inverse of those k rows of G.
"""

from __future__ import annotations

import functools

import numpy as np

PRIM_POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:] = exp[:255]
    a = np.arange(256)
    mul = exp[log[a][:, None] + log[a][None, :]]
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, log, mul.astype(np.uint8)


EXP, LOG, MUL = _tables()


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) product of an (r, k) matrix and (k, m) uint8 rows."""
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for i in range(A.shape[0]):
        for j in range(A.shape[1]):
            if A[i, j]:
                out[i] ^= MUL[int(A[i, j])][B[j]]
    return out


def mat_inv(A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square GF(2^8) matrix."""
    n = A.shape[0]
    aug = np.concatenate([np.asarray(A, np.uint8),
                          np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        nz = np.flatnonzero(aug[col:, col])
        if nz.size == 0:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        piv = col + int(nz[0])
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = MUL[inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col]:
                aug[r] ^= MUL[int(aug[r, col])][aug[col]]
    return aug[:, n:]


@functools.lru_cache(maxsize=None)
def generator(n: int, k: int) -> np.ndarray:
    G = np.zeros((n, k), dtype=np.uint8)
    G[:k] = np.eye(k, dtype=np.uint8)
    for i, x in enumerate(range(k, n)):
        for y in range(k):
            G[k + i, y] = inv(x ^ y)
    return G


@functools.lru_cache(maxsize=None)
def decoder(n: int, k: int, indices: tuple[int, ...]) -> np.ndarray:
    return mat_inv(generator(n, k)[list(indices)])


def piece_len(nbytes: int, k: int) -> int:
    return max(1, -(-nbytes // k))


def encode(blob: bytes, n: int, k: int) -> list[bytes]:
    """The n pieces of ``blob``."""
    L = piece_len(len(blob), k)
    rows = np.zeros(k * L, dtype=np.uint8)
    rows[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    out = mat_mul(generator(n, k), rows.reshape(k, L))
    return [out[i].tobytes() for i in range(n)]


def encode_many(blobs: list[bytes], n: int, k: int) -> list[list[bytes]]:
    """``encode`` of every blob, one product per piece length."""
    by_len: dict[int, list[int]] = {}
    for i, b in enumerate(blobs):
        by_len.setdefault(piece_len(len(b), k), []).append(i)
    G = generator(n, k)
    out: list[list[bytes]] = [[] for _ in blobs]
    for L, idxs in by_len.items():
        rows = np.zeros((len(idxs), k * L), dtype=np.uint8)
        for r, i in enumerate(idxs):
            rows[r, : len(blobs[i])] = np.frombuffer(blobs[i], np.uint8)
        rows = rows.reshape(len(idxs), k, L)
        pieces = np.zeros((len(idxs), n, L), dtype=np.uint8)
        pieces[:, :k] = rows
        for i in range(k, n):
            for j in range(k):
                pieces[:, i] ^= MUL[int(G[i, j])][rows[:, j]]
        for r, i in enumerate(idxs):
            out[i] = [pieces[r, p].tobytes() for p in range(n)]
    return out


def decode(pieces: dict[int, bytes], nbytes: int, n: int, k: int) -> bytes:
    """The blob of ``nbytes`` from at least k of its pieces."""
    idx = tuple(sorted(pieces)[:k])
    if len(idx) < k:
        raise ValueError(f"need {k} pieces, got {len(idx)}")
    rows = np.stack([np.frombuffer(pieces[i], dtype=np.uint8) for i in idx])
    return mat_mul(decoder(n, k, idx), rows).reshape(-1)[:nbytes].tobytes()
