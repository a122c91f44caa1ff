"""The bf16 flash kernel's shared-memory operands, emulated in numpy.

``csrc/flash_attn.cu``'s ``flash_wgmma_kernel`` has TMA write Q, K and V
tiles in swizzled boxes (64 columns in 128-byte rows where hd is a
multiple of 64, else 32 columns in 64-byte rows), and has ``wgmma`` read
them through matrix descriptors (``sm90.cuh``'s ``desc_sw``): Q and K
K-major for S = Q K^T, V MN-major for O += P V.  No card runs here, so
this file writes random tiles into a byte-addressed shared memory as TMA
swizzles them (16-byte chunk c of a row at c ^ the row's phase, taken
from address bits 7 and up), then decodes every operand of every
``wgmma`` the kernel issues from its descriptor (start address, leading
and stride byte offsets, swizzle) by the canonical layouts of the PTX
ISA, with the kernel's offsets (``Cfg``, kept in step with the source),
and checks that each operand is the slice of Q, K or V it means and that
the products are Q K^T and P V.  The 128-byte instances (hd 64, 128, 256)
have run on the card since they were written, which holds the emulation
to the hardware; hd 32 and 96 take the 64-byte rows.

The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use


class Cfg:
    """``tc::Cfg<HD>`` of the source."""

    def __init__(self, hd: int):
        self.HD = hd
        self.NCW = 3 if hd <= 64 else 2
        self.BW = 64 if hd % 64 == 0 else 32
        self.ROW = 2 * self.BW
        self.SBO = 8 * self.ROW
        self.NB = hd // self.BW
        self.BK = 64 if hd == 256 else 128
        self.STAGES = 2 if hd == 256 else 3
        self.Q_BYTES = self.NCW * self.NB * 64 * self.ROW
        self.KV_BYTES = self.NB * self.BK * self.ROW
        self.BAR_OFF = self.Q_BYTES + 2 * self.STAGES * self.KV_BYTES
        self.SMEM = self.BAR_OFF + 8 * (4 * self.STAGES + 1) + 1024


def swizzle(addr: np.ndarray, row: int) -> np.ndarray:
    """TMA's and wgmma's swizzle of rows of ``row`` bytes: the 16-byte
    chunk bits 4.. XOR the bits 7.. above them (Swizzle<2 or 3, 4, 3>)."""
    mask = row // 16 - 1
    return addr ^ (((addr >> 7) & mask) << 4)


class Smem:
    """Shared memory of one block, as bf16 bit patterns (uint16)."""

    def __init__(self, nbytes: int):
        self.h = np.zeros(nbytes // 2, dtype=np.uint16)
        self.written = np.zeros(nbytes // 2, dtype=bool)

    def tma_box(self, base: int, box: np.ndarray, row: int) -> None:
        """A (rows, row / 2) box of bf16 bits, swizzled as TMA writes it;
        the box starts on the swizzle's period (8 rows)."""
        assert base % (8 * row) == 0, "a box off the swizzle's period"
        r = np.arange(box.shape[0])[:, None]
        c = np.arange(box.shape[1])[None, :]
        addr = swizzle(base + r * row + 2 * c, row)
        assert not self.written[addr // 2].any(), "boxes overlap"
        self.h[addr // 2] = box
        self.written[addr // 2] = True

    def k_major(self, start: int, rows: int, sbo: int, row: int):
        """A K-major (rows, 16) operand: 8-row groups SBO apart, rows of
        ``row`` bytes; the start may sit 32-byte steps into a row."""
        mn = np.arange(rows)[:, None]
        k = np.arange(16)[None, :]
        addr = start + (mn % 8) * row + (mn // 8) * sbo + 2 * k
        return self.h[swizzle(addr, row) // 2]

    def mn_major(self, start: int, n: int, lbo: int, sbo: int, row: int):
        """An MN-major operand read as (16, n): column groups of row / 2
        LBO apart, 8-row groups along K SBO apart."""
        k = np.arange(16)[:, None]
        c = np.arange(n)[None, :]
        w = row // 2
        addr = (start + 2 * (c % w) + (c // w) * lbo + (k % 8) * row
                + (k // 8) * sbo)
        return self.h[swizzle(addr, row) // 2]


def _value(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as float64 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _bf16_bits(rng, shape) -> tuple[np.ndarray, np.ndarray]:
    """Random bf16 values: (bit patterns, their float64 values)."""
    x = rng.standard_normal(shape).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16)
    return bits, _value(bits)


HEAD_DIMS = [32, 64, 96, 128, 256]


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bf16_kernel_fits_one_block_an_sm(hd):
    """Every instance's Q tile and K / V ring fit a block's shared memory,
    each box on its swizzle's period; hd 32 and 96 take 64-byte rows."""
    C = Cfg(hd)
    assert C.SMEM <= SMEM_LIMIT
    assert C.NB * C.BW == hd and C.ROW == (128 if hd % 64 == 0 else 64)
    for off in (64 * C.ROW, C.BK * C.ROW, C.Q_BYTES, C.KV_BYTES):
        assert off % C.SBO == 0


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bf16_kernel_descriptors_read_their_operands(hd):
    C = Cfg(hd)
    rng = np.random.default_rng(hd)
    qb, Q = _bf16_bits(rng, (64 * C.NCW, hd))
    kb, K = _bf16_bits(rng, (C.BK, hd))
    vb, V = _bf16_bits(rng, (C.BK, hd))
    mem = Smem(C.BAR_OFF)
    s = C.STAGES - 1  # the ring slot K and V landed in
    sK = C.Q_BYTES
    sV = sK + C.STAGES * C.KV_BYTES
    # the producer's loads: Q once per consumer group, K and V per tile
    for w in range(C.NCW):
        for nb in range(C.NB):
            cols = slice(nb * C.BW, nb * C.BW + C.BW)
            mem.tma_box((w * C.NB + nb) * 64 * C.ROW,
                        qb[64 * w:64 * w + 64, cols], C.ROW)
    for nb in range(C.NB):
        cols = slice(nb * C.BW, nb * C.BW + C.BW)
        mem.tma_box(sK + s * C.KV_BYTES + nb * C.BK * C.ROW, kb[:, cols],
                    C.ROW)
        mem.tma_box(sV + s * C.KV_BYTES + nb * C.BK * C.ROW, vb[:, cols],
                    C.ROW)
    KB = C.BW // 16  # k16 steps a box
    P = rng.standard_normal((64, C.BK))
    for cw in range(C.NCW):
        qa = cw * C.NB * 64 * C.ROW
        ka = sK + s * C.KV_BYTES
        # issue_qk: one wgmma_ss a k16 step
        S = np.zeros((64, C.BK))
        for kk in range(hd // 16):
            a = mem.k_major(qa + (kk // KB) * 64 * C.ROW + (kk % KB) * 32,
                            64, C.SBO, C.ROW)
            b = mem.k_major(ka + (kk // KB) * C.BK * C.ROW + (kk % KB) * 32,
                            C.BK, C.SBO, C.ROW)
            np.testing.assert_array_equal(
                a, qb[64 * cw:64 * cw + 64, 16 * kk:16 * kk + 16])
            np.testing.assert_array_equal(b, kb[:, 16 * kk:16 * kk + 16])
            S += _value(a) @ _value(b).T
        np.testing.assert_allclose(S, Q[64 * cw:64 * cw + 64] @ K.T,
                                   rtol=1e-12, atol=1e-9)
    # issue_pv: one wgmma_rs a k16 step of keys, V MN-major
    va = sV + s * C.KV_BYTES
    O = np.zeros((64, hd))
    for j in range(C.BK // 16):
        b = mem.mn_major(va + j * 16 * C.ROW, hd, C.BK * C.ROW, C.SBO,
                         C.ROW)
        np.testing.assert_array_equal(b, vb[16 * j:16 * j + 16])
        O += P[:, 16 * j:16 * j + 16] @ _value(b)
    np.testing.assert_allclose(O, P @ V, rtol=1e-12, atol=1e-9)
