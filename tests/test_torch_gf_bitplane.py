"""K1's bit-plane algebra on the CPU, against the JAX reference.

The CUDA kernel (``csrc/gf_matmul.cu``) multiplies by a constant c one
bit plane at a time: with the byte masks of a 32-bit data word (byte n
of mask b is 0xFF where bit b of byte n is set),
``c * x = XOR_b (mask_b(x) & C_b)`` with ``C_b = c * 2^b`` in all four
bytes; an entry 0 adds nothing and an entry 1 adds x.  No CPU runs that
kernel, so this test emulates its per-word steps in numpy -- the masks
as the kernel forms them (shift left by 7 - b, then each byte's sign
replicated) and the 0/1 shortcuts -- from the wrapper's own constants
(``gf_matmul.bitplane_constants``), and holds the result exactly to the
port's plain version and to the reference's host product, as
``tests/test_torch_kernels.py`` runs it.  The constants are also held to
the reference's bit matrices (``repro.core.gf256.mul_bitmatrix``), the
TPU kernel's form of the same algebra.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import gf256 as jgf256
from repro.core import rs_code as jrs
from repro_torch.core import rs_code
from repro_torch.kernels import gf_matmul, ref, tables

ONE = np.uint32(0x01010101)


def _random_16_12() -> np.ndarray:
    """A random (16, 12) matrix with zeros and ones among its entries."""
    M = np.random.default_rng(12).integers(0, 256, (16, 12), dtype=np.uint8)
    M[0, :4] = 0
    M[1, 4:8] = 1
    return M


MATRICES = {
    "encode_10_5": lambda: rs_code.generator_matrix(10, 5),
    # parity pieces only: no unit row
    "decode_5_5": lambda: rs_code.decode_matrix(10, 5, (5, 6, 7, 8, 9)),
    # the pieces a repair reads after nodes 0, 2, 4, 6, 8 die: unit rows
    # for the data pieces 1 and 3
    "repair_5_5": lambda: rs_code.decode_matrix(10, 5, (1, 3, 5, 7, 9)),
    "random_16_12": _random_16_12,
}


def _masks(w: np.ndarray) -> list[np.ndarray]:
    """The kernel's eight byte masks of uint32 words: ``prmt`` in
    sign-replicate mode on ``w << (7 - b)``."""
    out = []
    for b in range(8):
        s = w << np.uint32(7 - b)
        sign = (s >> np.uint32(7)) & ONE  # bit 7 of each byte, to bit 0
        out.append(sign * np.uint32(0xFF))
    return out


def _emulate(consts: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The kernel's per-word algebra: (r, k, 8) constants x (B, k, L)."""
    r, k, _ = consts.shape
    B, _, L = data.shape
    words = np.ascontiguousarray(data).view("<u4")  # (B, k, L / 4)
    masks = [_masks(words[:, j]) for j in range(k)]
    acc = np.zeros((B, r, L // 4), dtype=np.uint32)
    for i in range(r):
        for j in range(k):
            c = consts[i, j]
            if c[0] == 0:
                continue
            if c[0] == ONE:
                acc[:, i] ^= words[:, j]
                continue
            for b in range(8):
                acc[:, i] ^= masks[j][b] & c[b]
    return acc.view(np.uint8).reshape(B, r, L)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bitplane_algebra_matches_reference(name):
    M = MATRICES[name]()
    r, k = M.shape
    consts = gf_matmul.bitplane_constants(M, tables.tables("cpu"))
    assert consts.shape == (r, k, 8) and consts.dtype == np.uint32
    # each word holds one byte four times: the reference's bit matrix
    # column b (bits of M[i, j] * 2^b)
    byte = consts & np.uint32(0xFF)
    assert np.array_equal(consts, byte * ONE)
    weights = 1 << np.arange(8)
    for i in range(r):
        for j in range(k):
            col = weights @ jgf256.mul_bitmatrix(int(M[i, j]))
            assert np.array_equal(byte[i, j], col), (i, j)
    rng = np.random.default_rng(r * 100 + k)
    data = rng.integers(0, 256, (3, k, 1024), dtype=np.uint8)
    data[0, :, ::5] = 0
    got = _emulate(consts, data)
    np.testing.assert_array_equal(
        got, ref.gf_matmul_ref(M, torch.from_numpy(data)).numpy())
    np.testing.assert_array_equal(got, jrs._gf_matmul_batched_np(M, data))


def test_shortcuts_cover_the_systematic_and_unit_rows():
    """The 0 and 1 entries the kernel skips or XORs are there: the (10,5)
    generator's identity rows and the repair matrix's unit rows."""
    t = tables.tables("cpu")
    for name, ones in (("encode_10_5", 5), ("repair_5_5", 2)):
        c0 = gf_matmul.bitplane_constants(MATRICES[name](), t)[..., 0]
        assert int((c0 == ONE).sum()) >= ones
        assert int((c0 == 0).sum()) >= 4 * ones
