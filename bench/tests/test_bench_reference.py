"""The plain reference: chunking, ids and Reed-Solomon on seeded data."""

import hashlib
import itertools

import numpy as np
import pytest

from bench.reference import cdc, ids, rs


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def test_gear_hash_is_the_byte_at_a_time_recurrence():
    data = np.frombuffer(_bytes(1, 3000), np.uint8)
    h, want = 0, []
    for b in data:
        h = (2 * h + int(cdc.GEAR_TABLE[b])) & 0xFFFFFFFF
        want.append(h)
    assert cdc.gear_hash(data).tolist() == want


@pytest.mark.parametrize("sizes", [(1024, 4096, 8192), (2048, 8192, 16384)])
def test_chunks_cover_the_file_within_their_limits(sizes):
    lo, avg, hi = sizes
    data = _bytes(2, 200_000)
    lengths = cdc.lengths(data, lo, avg, hi)
    assert sum(lengths) == len(data)
    assert all(lo < n <= hi for n in lengths[:-1]) and 0 < lengths[-1] <= hi
    # content-defined: a prefix edit moves no cut far behind it
    edited = b"\x00" * 10 + data[10:]
    cuts = set(cdc.boundaries(data, lo, avg, hi))
    later = [c for c in cdc.boundaries(edited, lo, avg, hi) if c > 3 * hi]
    assert later and set(later) <= cuts


def test_chunks_agree_with_the_program_on_seeded_data():
    from repro_torch.core.chunking import Chunker
    for seed, (lo, avg, hi) in enumerate([(1024, 4096, 8192),
                                          (2048, 8192, 16384)]):
        data = _bytes(10 + seed, 150_000)
        spans = Chunker(lo, avg, hi).chunk_spans(data)
        assert [n for _, n in spans] == cdc.lengths(data, lo, avg, hi)


def test_chunk_id_is_sha1():
    assert ids.chunk_id(b"abc").hex() == \
        "a9993e364706816aba3e25717850c26c9cd0d89d"
    blob = _bytes(3, 5000)
    assert ids.chunk_id(blob) == hashlib.sha1(blob).digest()


def test_gf_field_axioms_on_every_element():
    a = np.arange(1, 256)
    inv = np.array([rs.inv(int(x)) for x in a])
    assert (rs.MUL[a, inv] == 1).all()
    assert (rs.MUL[0] == 0).all() and (rs.MUL[1] == np.arange(256)).all()
    x, y, z = (np.random.default_rng(4).integers(0, 256, 500) for _ in "xyz")
    assert (rs.MUL[x, rs.MUL[y, z]] == rs.MUL[rs.MUL[x, y], z]).all()
    assert (rs.MUL[x, y ^ z] == rs.MUL[x, y] ^ rs.MUL[x, z]).all()


@pytest.mark.parametrize("n,k", [(6, 3), (7, 4)])
def test_decode_from_every_k_subset(n, k):
    blob = _bytes(5, 1000 + n)
    pieces = rs.encode(blob, n, k)
    assert b"".join(pieces[:k])[:len(blob)] == blob  # systematic
    for subset in itertools.combinations(range(n), k):
        got = rs.decode({i: pieces[i] for i in subset}, len(blob), n, k)
        assert got == blob, subset


@pytest.mark.parametrize("n,k", [(10, 5), (14, 10)])
def test_encode_agrees_with_the_program(n, k):
    from repro_torch.core.rs_code import RSCode
    blobs = [_bytes(6 + i, size) for i, size in enumerate((1, 999, 8192))]
    code = RSCode(n, k)
    assert rs.encode_many(blobs, n, k) == [code.encode_bytes(b)
                                           for b in blobs]
    assert [rs.encode(b, n, k) for b in blobs] == rs.encode_many(blobs, n, k)
