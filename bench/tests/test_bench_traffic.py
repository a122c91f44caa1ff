"""The traffic generator: deterministic in the seed, at its stated fractions."""

import numpy as np
import torch

from bench.harness import traffic

KiB = 1 << 10
MIXED = traffic.Content(users=3, files_per_user=4, file_bytes=256 * KiB,
                        block=4 * KiB, shared_fraction=0.35,
                        pool_blocks=16)
IMAGES = traffic.Content(users=2, files_per_user=1, file_bytes=1 << 20,
                         churn=0.03, spot=4 * KiB)
BIG_SEED = 2**31 + 977


def _rounds(content, seed, count):
    gen = traffic.Generator(content, seed, torch.device("cpu"))
    return gen, [gen.round() for _ in range(count)]


def test_same_seed_same_rounds_other_seed_other_bytes():
    _, a = _rounds(MIXED, BIG_SEED, 2)
    _, b = _rounds(MIXED, BIG_SEED, 2)
    _, c = _rounds(MIXED, BIG_SEED + 1, 2)
    assert a == b
    assert [d for _, _, d in a[0]] != [d for _, _, d in c[0]]
    assert [(u, f, len(d)) for u, f, d in a[0]] == \
        [(u, f, len(d)) for u, f, d in c[0]]  # same sizes, every seed
    assert traffic.derive(BIG_SEED, "x") == traffic.derive(BIG_SEED, "x")


def test_shared_fraction_and_fresh_private_blocks():
    gen, rounds = _rounds(MIXED, BIG_SEED, 3)
    pool = {gen.pool[i].tobytes() for i in range(MIXED.pool_blocks)}
    shared = private = 0
    seen_private = set()
    for files in rounds:
        assert len(files) == MIXED.users * MIXED.files_per_user
        for _, _, data in files:
            assert len(data) == MIXED.file_bytes
            for s in range(0, len(data), MIXED.block):
                blk = data[s:s + MIXED.block]
                if blk in pool:
                    shared += 1
                else:
                    private += 1
                    assert blk not in seen_private  # nothing reused
                    seen_private.add(blk)
    assert abs(shared / (shared + private) - 0.35) < 0.03
    assert len(pool) == MIXED.pool_blocks
    assert len(gen.pool_file()) == MIXED.pool_blocks * MIXED.block


def test_corpus_is_shared_by_every_seed():
    a, ra = _rounds(MIXED, BIG_SEED, 1)
    b, rb = _rounds(MIXED, BIG_SEED + 5, 1)
    assert (a.pool == b.pool).all()
    _, ia = _rounds(IMAGES, BIG_SEED, 2)
    _, ib = _rounds(IMAGES, BIG_SEED + 5, 2)
    assert ia[0] == ib[0] and ia[1] != ib[1]  # generation 0, then edits


def test_backup_generations_churn_three_percent_in_spots():
    _, rounds = _rounds(IMAGES, BIG_SEED, 4)
    for prev, cur in zip(rounds, rounds[1:]):
        for (u0, _, a), (u1, _, b) in zip(prev, cur):
            assert u0 == u1 and len(a) == len(b) == IMAGES.file_bytes
            x = np.frombuffer(a, np.uint8)
            y = np.frombuffer(b, np.uint8)
            spots = max(1, int(IMAGES.file_bytes * IMAGES.churn) // IMAGES.spot)
            # rewritten bytes: the spots (overlaps and equal bytes aside)
            changed = int((x != y).sum())
            assert 0.8 * spots * IMAGES.spot < changed <= spots * IMAGES.spot
    names = {(u, f) for files in rounds for u, f, _ in files}
    assert len(names) == 4 * IMAGES.users
