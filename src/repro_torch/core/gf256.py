"""GF(2^8) arithmetic for Reed-Solomon erasure coding.

Two representations are maintained:

1. **log/exp tables** (classic software RS): ``mul(a,b) = EXP[LOG[a]+LOG[b]]``.
   Used by the plain torch version (``kernels/ref.py``), by host-side
   numpy helpers (matrix inversion for decode) and, through
   ``kernels/tables.py``, to build the CUDA kernels' constants.

2. **bit-matrix (bit-sliced) form**: multiplication by a fixed constant
   ``c`` in GF(2^8) is linear over GF(2), i.e. an 8x8 0/1 matrix ``M_c``
   acting on the bit vector of the operand.  An (n,k) GF(256) matmul
   therefore lifts to an (8n, 8k) GF(2) matmul followed by ``mod 2``.
   The port's CUDA GF products (``csrc/gf_bitplane.cuh``, run by the GF
   kernel and the fused ingest kernel) use this form one bit plane at a
   time: ``c * x = XOR_b x_b * (c * 2^b)``, with the constants
   ``c * 2^b`` built from the tables (``Tables.gf_bitplane``).  The
   bit matrices are kept as host helpers.

The field is GF(2^8) with the standard primitive polynomial
x^8 + x^4 + x^3 + x^2 + 1 (0x11D), generator alpha = 2.
"""

from __future__ import annotations

import functools

import numpy as np

PRIM_POLY = 0x11D  # x^8+x^4+x^3+x^2+1
FIELD = 256
ORDER = FIELD - 1  # multiplicative group order (255)


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2 * ORDER, dtype=np.int32)  # doubled to skip the mod-255
    log = np.zeros(FIELD, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[ORDER : 2 * ORDER] = exp[:ORDER]
    log[0] = 0  # unused; multiplication by zero is special-cased
    return exp, log


GF_EXP, GF_LOG = _build_tables()


# ---------------------------------------------------------------------------
# numpy scalar/array field ops (host-side: matrix inversion, test oracles)
# ---------------------------------------------------------------------------

def gf_mul(a, b):
    """Elementwise GF(256) multiply of integer arrays (any shape, broadcast)."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = GF_EXP[GF_LOG[a] + GF_LOG[b]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.int32)


def gf_inv(a):
    a = np.asarray(a, dtype=np.int32)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    return GF_EXP[ORDER - GF_LOG[a]].astype(np.int32)


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * e) % ORDER])


def gf_matmul_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(256) matrix product (host numpy; O(n^3) table path)."""
    A = np.asarray(A, dtype=np.int32)
    B = np.asarray(B, dtype=np.int32)
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.int32)
    for i in range(A.shape[1]):
        out ^= gf_mul(A[:, i : i + 1], B[i : i + 1, :])
    return out


def gf_mat_inv(A: np.ndarray) -> np.ndarray:
    """Invert a square GF(256) matrix by Gauss-Jordan elimination."""
    A = np.asarray(A, dtype=np.int32).copy()
    n = A.shape[0]
    assert A.shape == (n, n)
    aug = np.concatenate([A, np.eye(n, dtype=np.int32)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf_mul(aug[col], gf_inv(aug[col, col]))
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= gf_mul(aug[r, col], aug[col])
    return aug[:, n:]


# ---------------------------------------------------------------------------
# bit-matrix (bit-sliced GF(2)) representation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mul_bitmatrix_cached(c: int) -> bytes:
    """8x8 GF(2) matrix M such that bits(c*x) = M @ bits(x) mod 2.

    Column j of M is the bit vector of c * 2^j in GF(256).  Bit order is
    little-endian (bit i of the byte = row i).
    """
    cols = []
    for j in range(8):
        v = gf_mul(c, 1 << j)
        cols.append([(int(v) >> i) & 1 for i in range(8)])
    m = np.array(cols, dtype=np.int32).T  # (8 rows, 8 cols)
    return m.tobytes()


def mul_bitmatrix(c: int) -> np.ndarray:
    return np.frombuffer(_mul_bitmatrix_cached(int(c)), dtype=np.int32).reshape(8, 8)


def gf_matrix_to_bits(G: np.ndarray) -> np.ndarray:
    """Lift an (n,k) GF(256) matrix to its (8n, 8k) GF(2) bit-matrix."""
    G = np.asarray(G, dtype=np.int32)
    n, k = G.shape
    out = np.zeros((8 * n, 8 * k), dtype=np.int32)
    for i in range(n):
        for j in range(k):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = mul_bitmatrix(int(G[i, j]))
    return out


def bytes_to_bits_np(x: np.ndarray) -> np.ndarray:
    """(..., m) uint8 -> (..., 8m) 0/1 int8, little-endian within the byte.

    Row-block layout: output[..., 8*i + b] = bit b of byte i is NOT used;
    instead we use the *interleaved-by-bit* layout that matches
    ``gf_matrix_to_bits``: byte i contributes rows/cols ``8*i .. 8*i+7``.
    """
    x = np.asarray(x, dtype=np.uint8)
    shifts = np.arange(8, dtype=np.uint8)
    bits = (x[..., :, None] >> shifts) & 1  # (..., m, 8)
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 8).astype(np.int8)


def bits_to_bytes_np(b: np.ndarray) -> np.ndarray:
    """Inverse of :func:`bytes_to_bits_np`."""
    b = np.asarray(b, dtype=np.uint8)
    assert b.shape[-1] % 8 == 0
    m = b.shape[-1] // 8
    bits = b.reshape(*b.shape[:-1], m, 8)
    weights = (1 << np.arange(8)).astype(np.uint16)
    return (bits.astype(np.uint16) * weights).sum(-1).astype(np.uint8)
