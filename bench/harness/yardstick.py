"""The least time a kernel's work needs on the card: frozen arithmetic.

Copied from ``chip_smoke.py`` (``SHA1_OPS_PER_BLOCK``, ``gf_ops``,
``int_peak``, ``bound``) so that the program cannot change its own
yardstick.  A kernel's least time is the larger of its bytes (each input
byte read once, each output byte written once) at HBM's 3.35e12 B/s and
its 32-bit integer operations at the card's integer peak, 64 a clock an
SM x SMs x the maximum SM clock that ``nvidia-smi`` reports.
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
INT_OPS_PER_SM_CLOCK = 64
# SHA-1 integer operations per 64-byte block in the card's 3-input forms:
# 64 schedule words x (two 3-input XORs + a rotate) + 80 rounds x (f as
# one LOP3, two adds, rotl(a, 5) + X as one LEA.HI, rotl(b, 30)) + 5 adds.
SHA1_OPS_PER_BLOCK = 64 * 3 + 80 * 5 + 5
# GF(2^8) product by bit planes, per 32-bit word of data: 15 operations
# for the byte masks of an input column with an entry neither 0 nor 1,
# 8 AND-XORs a such entry, one XOR an entry 1, nothing for an entry 0.
GF_MASK_OPS, GF_ENTRY_OPS = 15, 8


def int_peak(sms: int, max_sm_mhz: float) -> dict:
    """The card's 32-bit integer peak from its SM count and the maximum SM
    clock that ``nvidia-smi --query-gpu=clocks.max.sm`` reports."""
    return {"ops_per_s": INT_OPS_PER_SM_CLOCK * sms * max_sm_mhz * 1e6,
            "sms": sms, "max_sm_mhz": max_sm_mhz}


def gf_ops(M, words: int) -> int:
    """Operations an (r, k) matrix ``M`` times (k, 4 x ``words``) bytes needs."""
    M = np.asarray(M)
    general = (M != 0) & (M != 1)
    return words * (GF_MASK_OPS * int(general.any(axis=0).sum())
                    + GF_ENTRY_OPS * int(general.sum())
                    + int((M == 1).sum()))


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(least seconds, which term sets it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / peak_ops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sha1_blocks(nbytes: int) -> int:
    """64-byte blocks of a padded SHA-1 message of ``nbytes``."""
    return (nbytes + 8) // 64 + 1


def piece_len(nbytes: int, k: int) -> int:
    return max(1, -(-nbytes // k))


def fused_ingest_work(jobs) -> tuple[int, int]:
    """(bytes, operations) of hashing and encoding (n, k, nbytes) jobs.

    Each chunk is read once and its n pieces and 20-byte digest written
    once; the operations are SHA-1's.  The GF products count as bytes
    only, so the count is the same whatever kernel does the work.
    """
    nbytes = ops = 0
    for n, k, length in jobs:
        nbytes += length + n * piece_len(length, k) + 20
        ops += sha1_blocks(length) * SHA1_OPS_PER_BLOCK
    return nbytes, ops


def decode_work(jobs) -> int:
    """Bytes of decoding (k, nbytes) jobs: k pieces read, the blob written."""
    return sum(k * piece_len(length, k) + length for k, length in jobs)
