"""K5's SHA-1 staging plan and K3's store order on the CPU, against the
JAX reference.

No CPU runs the CUDA kernels, so these tests emulate in numpy what they
do word by word.

K5 (``csrc/fused_ingest.cu``): its two assembler warps turn the even and
the odd 64-byte blocks of a chunk packed as ``rs_code.pack_blob`` lays
it out (row i / L, column i % L of a (k, Lp) slab) into 16 big-endian
SHA-1 words.  The emulation follows them step by step: each one's
cursor, 128 bytes a step; which 16-byte granules of which rows it stages
(the five of the block's row from its column rounded down to 16, the
first four of the next row when the block runs past the row end, only
those that hold message bytes) into its ring of two staging slots whose
other bytes hold stale data (random here, so a byte the kernel must mask
shows), then the one-PRMT funnel of a block inside its row and
the message, the general form of any other block (row part and next-row
part joined by a byte mask, bytes past the message cleared, 0x80), the
byte-by-byte path of rows under 64 bytes, and the bit length.  The
result is held exactly to the reference's host padding
(``repro.core.hashing.sha1_pad_batch``) and to the port's plain version
(``ref._sha1_pad_packed``), for lengths around each row end, piece
lengths that are not multiples of 4 or 16, both codes of the main path
and pad rows.

K3 (``csrc/gear_cdc.cu``, hash form): each thread still runs the
recurrence h = 2h + gear[b] over its 32 positions after a 32-byte
warm-up; each warp passes its hashes through XOR-swizzled shared memory
and stores them as 512-byte rows.  The emulation follows that store
order and is held to the reference's ``gear_hash_np``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import chunking as jchunking
from repro.core import hashing as jhashing
from repro_torch.core import rs_code
from repro_torch.kernels import gf_matmul, ref

U32 = np.uint32
FULL = 0xFFFFFFFF
ASSEMBLERS, STAGE_SLOTS, ROW_PART, STAGE_BYTES = 2, 2, 80, 144


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm`` for selectors whose nibbles are 0..7."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _be_sel(q: int) -> int:
    return (q << 12) | ((q + 1) << 8) | ((q + 2) << 4) | (q + 3)


def _head_bytes(d: int) -> int:
    return ~(FULL >> (8 * min(max(d, 0), 4))) & FULL


def _assemble(st: list[int], sa: int, a: int, rem: int) -> list[int]:
    """The 16 words of a staged block (``st``: its 36 staging words):
    one PRMT a word inside the row and the message, else the general
    form."""
    if a >= 64 and rem >= 64:
        p, sel = sa >> 2, _be_sel(sa & 3)
        return [_byte_perm(st[p + j], st[p + j + 1], sel)
                for j in range(16)]
    qb = ROW_PART - min(a, 64)
    sel_a, sel_b = _be_sel(sa & 3), _be_sel(qb & 3)
    w = []
    for j in range(16):
        qa, qn = sa + 4 * j, qb + 4 * j
        wa = _byte_perm(st[qa >> 2], st[(qa >> 2) + 1], sel_a)
        wn = _byte_perm(st[qn >> 2], st[(qn >> 2) + 1], sel_b)
        from_row = _head_bytes(a - 4 * j)
        e = rem - 4 * j
        v = ((wa & from_row) | (wn & ~from_row & FULL)) & _head_bytes(e)
        if 0 <= e < 4:
            v |= 0x80000000 >> (8 * e)
        w.append(v)
    return w


def _bytewise(slab: np.ndarray, m: int, L: int, rem: int) -> list[int]:
    """Rows under 64 bytes: the block's words byte by byte from the slab."""
    r, c = divmod(64 * m, L)
    w = []
    for j in range(16):
        v = 0
        for t in range(4):
            at, byte = 4 * j + t, 0
            if at < rem:
                byte = int(slab[r, c])
                c += 1
                if c == L:
                    c, r = 0, r + 1
            elif at == rem:
                byte = 0x80
            v = (v << 8) | byte
        w.append(v)
    return w


def _emulate(slab: np.ndarray, n: int, L: int, rng) -> np.ndarray:
    """The assemblers' (nb, 16) big-endian words of one packed chunk."""
    k, Lp = slab.shape
    L = min(max(L, 1), Lp)
    n = min(max(n, 0), k * L)
    nb = (n + 8) // 64 + 1
    tiny = L < 64
    step = 64 * ASSEMBLERS
    out = np.zeros((nb, 16), dtype=U32)
    for aid in range(ASSEMBLERS):  # blocks m = aid, aid + ASSEMBLERS, ...
        ring = rng.integers(0, 256, (STAGE_SLOTS, STAGE_BYTES),
                            dtype=np.uint8)
        srow, scol, col = 0, 64 * aid, 64 * aid
        if not tiny and scol >= L:
            scol, srow, col = scol - L, 1, col - L
        for i, m in enumerate(range(aid, nb, ASSEMBLERS)):
            slot = ring[i % STAGE_SLOTS]
            if not tiny:  # stage: the granules that hold message bytes
                left = n - srow * L
                a_end = min(scol + 64, L, left)
                c0 = scol & ~15
                for q in range(5):
                    if c0 + 16 * q < a_end:
                        assert c0 + 16 * q + 16 <= Lp
                        slot[16 * q:16 * q + 16] = \
                            slab[srow, c0 + 16 * q:c0 + 16 * q + 16]
                b_end = min(64 - (L - scol), left - L)
                for q in range(4):
                    if 16 * q < b_end:
                        assert srow + 1 < k
                        slot[ROW_PART + 16 * q:ROW_PART + 16 * q + 16] = \
                            slab[srow + 1, 16 * q:16 * q + 16]
                scol += step
                for _ in range(ASSEMBLERS):
                    if scol >= L:
                        scol, srow = scol - L, srow + 1
            rem = n - 64 * m
            if tiny:
                w = _bytewise(slab, m, L, rem)
            else:
                w = _assemble([int(x) for x in slot.view("<u4")],
                              col & 15, L - col, rem)
                col += step
                for _ in range(ASSEMBLERS):
                    if col >= L:
                        col -= L
            if m == nb - 1:
                w[14], w[15] = (8 * n) >> 32, (8 * n) & FULL
            out[m] = w
    return out


EDGES = (0, 1, 55, 56, 63, 64, 119, 120)


def _lengths(k: int, L: int) -> list[int]:
    """Message lengths that fit k rows of L: the edges, and lengths
    around each row end."""
    ns = set(EDGES)
    for j in range(1, k + 1):
        ns.update(j * L + d for d in (-64, -57, -56, -9, -8, -1, 0, 1, 8))
    return sorted(x for x in ns if 0 <= x <= k * L)


@pytest.mark.parametrize("nk,L", [(nk, L) for nk in ((10, 5), (14, 10))
                                  for L in (1, 3, 17, 511, 1639)],
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else f"L{x}")
def test_fused_staging_matches_reference_padding(nk, L):
    n_code, k = nk
    Lp = gf_matmul.TILE_L * -(-L // gf_matmul.TILE_L)
    rng = np.random.default_rng(100 * k + L)
    lens = _lengths(k, L)
    msgs = [rng.bytes(x) for x in lens]
    slabs = np.stack([rs_code.pack_blob(m, k, L, Lp) for m in msgs])
    # pad rows: nothing packed, length 0, piece length 1
    slabs = np.concatenate([slabs, np.zeros((2, k, Lp), np.uint8)])
    msgs += [b"", b""]
    nbytes = np.asarray(lens + [0, 0], np.int32)
    plens = np.asarray([L] * len(lens) + [1, 1], np.int32)
    want, counts = jhashing.sha1_pad_batch(msgs)
    port, pcounts = ref._sha1_pad_packed(torch.from_numpy(slabs),
                                         torch.from_numpy(nbytes),
                                         torch.from_numpy(plens))
    port = port.numpy().astype(U32)
    assert np.array_equal(pcounts.numpy(), counts)
    for b in range(len(msgs)):
        got = _emulate(slabs[b], int(nbytes[b]), int(plens[b]), rng)
        nb = int(counts[b])
        assert got.shape == (nb, 16), (b, nbytes[b])
        assert np.array_equal(got, want[b, :nb]), (nk, L, int(nbytes[b]))
        assert np.array_equal(got, port[b, :nb]), (nk, L, int(nbytes[b]))


def _gear_kernel_hash(stream: np.ndarray, gear: np.ndarray) -> np.ndarray:
    """K3's hash form: per thread the recurrence over 32 positions after a
    32-byte warm-up, per warp the swizzled staging and 512-byte rows."""
    seg, lanes = 32, 32
    n = stream.shape[0]
    assert n % (seg * lanes) == 0
    out = np.zeros(n, dtype=U32)
    for w0 in range(0, n, seg * lanes):
        stage = np.zeros((lanes * 8, 4), dtype=U32)
        for lane in range(lanes):
            t0 = w0 + lane * seg
            h = 0
            if t0 > 0:
                for b in stream[t0 - seg:t0]:
                    h = ((h << 1) + int(gear[b])) & FULL
            hs = []
            for b in stream[t0:t0 + seg]:
                h = ((h << 1) + int(gear[b])) & FULL
                hs.append(h)
            for q in range(8):
                stage[lane * 8 + (q ^ (lane & 7))] = hs[4 * q:4 * q + 4]
        for i in range(8):
            for lane in range(lanes):
                c = i * 32 + lane
                row = c >> 3
                out[w0 + 4 * c:w0 + 4 * c + 4] = \
                    stage[row * 8 + ((c & 7) ^ (row & 7))]
    return out


def test_gear_hash_store_order_matches_reference():
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 256, 3 * 1024, dtype=np.uint8)
    got = _gear_kernel_hash(stream, jchunking.GEAR_TABLE)
    assert np.array_equal(got, jchunking.gear_hash_np(stream))
