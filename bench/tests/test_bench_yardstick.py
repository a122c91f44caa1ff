"""The kernels' yardstick on hand-sized jobs."""

import numpy as np
import pytest

from bench.harness import yardstick
from bench.reference import rs

PEAK = 64 * 132 * 1980e6  # the data sheet's SMs and maximum clock


def test_sha1_blocks_follow_the_padding_rule():
    assert [yardstick.sha1_blocks(n) for n in (0, 55, 56, 64, 119, 120)] == \
        [1, 1, 2, 2, 2, 3]
    assert yardstick.SHA1_OPS_PER_BLOCK == 597


def test_fused_ingest_yardstick_by_hand():
    # two chunks at (10, 5): 4096 bytes -> pieces of 820, 100 -> 20
    nbytes, ops = yardstick.fused_ingest_work([(10, 5, 4096), (10, 5, 100)])
    assert nbytes == (4096 + 10 * 820 + 20) + (100 + 10 * 20 + 20)
    assert ops == (65 + 2) * 597
    t, term = yardstick.bound(nbytes, ops, PEAK)
    # at (10, 5) the pieces written outweigh SHA-1's operations
    assert term == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    t, term = yardstick.bound(nbytes, ops, PEAK / 4)
    assert term == "operations" and t == pytest.approx(ops / (PEAK / 4))


def test_decode_yardstick_by_hand():
    # (14, 10): a 16384-byte chunk reads 10 pieces of 1639, writes 16384
    nbytes = yardstick.decode_work([(10, 16384), (5, 4096)])
    assert nbytes == 10 * 1639 + 16384 + 5 * 820 + 4096
    t, term = yardstick.bound(nbytes, 0, PEAK)
    assert term == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_gf_ops_count_only_general_entries():
    G = rs.generator(10, 5)
    # the identity rows cost one XOR an entry 1; the Cauchy rows are general
    words = 256
    general = (G != 0) & (G != 1)
    want = words * (15 * int(general.any(axis=0).sum())
                    + 8 * int(general.sum()) + int((G == 1).sum()))
    assert yardstick.gf_ops(G, words) == want
    assert yardstick.gf_ops(np.eye(4, dtype=np.uint8), words) == 4 * words
