"""The fp32 flash kernel's shared-memory addressing, emulated in numpy.

``csrc/flash_attn.cu``'s ``flash_fma_kernel`` reads tiles that TMA wrote
with the 128-byte swizzle (16-byte chunk c of a box's row r at c ^ r % 8)
through addresses that carry the thread's swizzle phase in bits 4-6, and
passes p between lanes through a warp-private buffer with padded rows.
No card runs here, so this file writes random Q, K and V tiles into a
byte-addressed shared memory as TMA lays them out, then replays every
load and store of one tile's Q.K^T and P.V with the kernel's address
expressions (``Cfg``, the lane layout and the XORs, kept in step with the
source) for every warp, and checks that

- each thread's scores are its rows of Q K^T and its outputs its slice of
  P V, so every address lands on the element it means;
- every warp-wide 16-byte load touches at most 8 distinct chunks on
  distinct bank groups (one wavefront), and every 4-byte store of p hits
  32 distinct banks.

The kernel itself is held against its plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

ROW = 128  # bytes: one 32-column fp32 swizzle row


class Cfg:
    """``fp32::Cfg<HD>`` of the source."""

    def __init__(self, hd: int):
        self.HD, self.NB = hd, hd // 32
        self.MQ = 8 if hd <= 64 else 4 if hd <= 128 else 2
        self.WQ, self.NW, self.BK = 4 * self.MQ, 8, 64
        self.BQ, self.MK = self.NW * self.WQ, self.BK // 8
        self.SLOTS = {32: 8, 64: 4, 96: 4, 128: 3, 256: 2}[hd]
        self.PST = self.BK + 8
        self.Q_BYTES = self.NB * self.BQ * ROW
        self.TILE = self.NB * self.BK * ROW
        self.P_OFF = self.Q_BYTES + self.SLOTS * self.TILE
        self.END = self.P_OFF + self.NW * self.WQ * self.PST * 4
        # the barriers and release counts, and the 1024-byte alignment
        self.SMEM = self.END + 8 * (self.SLOTS + 1) + 4 * self.SLOTS + 1024


class Smem:
    """Shared memory of one block, as fp32 words, with the bank checks."""

    def __init__(self, nbytes: int):
        self.w = np.full(nbytes // 4, np.nan, dtype=np.float32)
        self.loads = 0

    def tma_box(self, base: int, rows: np.ndarray) -> None:
        """A (n, 32) box written as TMA's 128-byte swizzle lays it out."""
        r = np.arange(rows.shape[0])[:, None]
        c = np.arange(8)[None, :]
        addr = base + r * ROW + ((c ^ (r % 8)) << 4)
        self.w[addr[..., None] // 4 + np.arange(4)] = rows.reshape(-1, 8, 4)

    def lds128(self, addr: np.ndarray) -> np.ndarray:
        """One warp-wide ld.shared.v4.f32: (32,) byte addresses."""
        assert (addr % 16 == 0).all()
        chunks = np.unique(addr)
        assert len(chunks) <= 8, f"{len(chunks)} chunks: > 1 wavefront"
        assert len(np.unique((chunks >> 4) % 8)) == len(chunks), \
            "two chunks on one bank group"
        self.loads += 1
        return self.w[addr[:, None] // 4 + np.arange(4)]

    def sts32(self, addr: np.ndarray, x: np.ndarray) -> None:
        """One warp-wide st.shared.f32: 32 addresses on 32 banks."""
        assert len(np.unique((addr >> 2) % 32)) == 32
        self.w[addr // 4] = x


SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
def test_fp32_kernel_fits_one_block_an_sm(hd):
    """Every instance's ring, Q tile and p buffers fit a block's shared
    memory, Q and every ring slot on 1024 bytes (the swizzle's period),
    and an even MQ keeps the Q rows' phases at qg ^ 4 (i & 1)."""
    C = Cfg(hd)
    assert C.SMEM <= SMEM_LIMIT
    assert C.Q_BYTES % 1024 == 0 and C.TILE % 1024 == 0
    assert C.BQ * ROW % 1024 == 0 and C.BK * ROW % 1024 == 0
    assert C.MQ % 2 == 0 and C.WQ % 8 == 0 and C.BQ <= 256  # a TMA box


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 256])
def test_fp32_kernel_addresses_read_their_elements_conflict_free(hd):
    C = Cfg(hd)
    rng = np.random.default_rng(hd)
    Q = rng.standard_normal((C.BQ, hd), dtype=np.float32)
    K = rng.standard_normal((C.BK, hd), dtype=np.float32)
    V = rng.standard_normal((C.BK, hd), dtype=np.float32)
    mem = Smem(C.END)
    sk, sv = C.SLOTS - 1, 0  # the ring slots K and V landed in
    for nb in range(C.NB):
        cols = slice(32 * nb, 32 * nb + 32)
        mem.tma_box(nb * C.BQ * ROW, Q[:, cols])
        mem.tma_box(C.Q_BYTES + sk * C.TILE + nb * C.BK * ROW, K[:, cols])
        mem.tma_box(C.Q_BYTES + sv * C.TILE + nb * C.BK * ROW, V[:, cols])

    lane = np.arange(32)
    qg, kg = lane >> 3, lane & 7
    i_ = np.arange(C.MQ)
    for warp in range(C.NW):
        rows = warp * C.WQ + qg[:, None] + 4 * i_  # (lane, i)
        keys = kg[:, None] + 8 * np.arange(C.MK)   # (lane, j)
        qx = (warp * C.WQ + qg) * ROW + (qg << 4)
        kx0 = C.Q_BYTES + kg * ROW + (kg << 4)
        vx0 = C.Q_BYTES + (kg << 4)
        px = C.P_OFF + (warp * C.WQ + qg) * C.PST * 4

        # S = Q K^T, 16-byte chunk c of each box in step
        sc = np.zeros((32, C.MQ, C.MK))
        for nb in range(C.NB):
            kb = kx0 + sk * C.TILE + nb * C.BK * ROW
            qb = qx + nb * C.BQ * ROW
            for c in range(8):
                kf = [mem.lds128((kb ^ (c << 4)) + j * 8 * ROW)
                      for j in range(C.MK)]
                for i in range(C.MQ):
                    qf = mem.lds128((qb ^ ((c ^ 4 * (i & 1)) << 4))
                                    + i * 4 * ROW)
                    for j in range(C.MK):
                        sc[:, i, j] += (qf.astype(np.float64)
                                        * kf[j]).sum(-1)
        want = np.einsum("lid,ljd->lij", Q[rows].astype(np.float64),
                         K[keys].astype(np.float64))
        np.testing.assert_allclose(sc, want, rtol=1e-5, atol=1e-4)

        # p into the warp's buffer, then O += P V key by key
        p = rng.standard_normal((32, C.MQ, C.MK), dtype=np.float32)
        for i in range(C.MQ):
            for j in range(C.MK):
                mem.sts32(px + (4 * i * C.PST + kg + 8 * j) * 4, p[:, i, j])
        acc = np.zeros((32, C.MQ, C.NB, 4))
        vb = vx0 + sv * C.TILE
        for kk in range(C.BK // 8):
            pf = [[mem.lds128(px + (4 * i * C.PST + 8 * kk + 4 * hh) * 4)
                   for hh in range(2)] for i in range(C.MQ)]
            vk = vb + kk * 8 * ROW
            for r in range(8):
                va = (vk ^ (r << 4)) + r * ROW
                vf = [mem.lds128(va + t * C.BK * ROW) for t in range(C.NB)]
                for i in range(C.MQ):
                    for t in range(C.NB):
                        acc[:, i, t] += (pf[i][r >> 2][:, r & 3, None]
                                         * vf[t].astype(np.float64))
        # the warp's P matrix from the lanes that wrote it
        P = np.zeros((C.WQ, C.BK))
        P[(qg[:, None, None] + 4 * i_[None, :, None]),
          keys[:, None, :]] = p
        cols = 32 * np.arange(C.NB)[None, :, None] + 4 * kg[:, None, None] \
            + np.arange(4)
        want = np.einsum("lik,lktc->litc",
                         P[qg[:, None] + 4 * i_],
                         V[:, cols].transpose(1, 0, 2, 3))
        np.testing.assert_allclose(acc, want, rtol=1e-5, atol=1e-4)
    # every product read: Q.K^T's chunks and P.V's p and V rows
    assert mem.loads == C.NW * (C.NB * 8 * (C.MK + C.MQ)
                                + C.BK // 8 * (2 * C.MQ + 8 * C.NB))
