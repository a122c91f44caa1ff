"""Plain torch versions of the port's kernels vs the JAX reference.

Every comparison is exact (integer kernels: tolerance 0).  Inputs are
made with numpy from a seed and handed to both packages.  The JAX side
runs its pure-jnp oracles (``repro.kernels.ref``, jitted where eager
dispatch would compile op by op) and the host oracles its own tier-1
tests pin them to: ``rs_code._gf_matmul_batched_np``,
``chunking.gear_hash_sequential`` and ``hashlib``.
"""

from __future__ import annotations

import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.core import chunking as jchunking
from repro.core import gf256 as jgf256
from repro.core import hashing as jhashing
from repro.core import rs_code as jrs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import chunking, gf256, hashing, rs_code
from repro_torch.core.classes import StorageClass
from repro_torch.kernels import gear_cdc, ops, ref, tables

CPU = torch.device("cpu")
MASKS = [StorageClass.realtime().chunker.mask,
         StorageClass.archival().chunker.mask]


@pytest.fixture
def default_tables():
    """Tests that load other tables put the port's own back afterwards."""
    yield
    ops.load_tables(device=CPU)


def _matrix(n: int, k: int, kind: str) -> np.ndarray:
    if kind == "encode":
        return rs_code.generator_matrix(n, k)
    idx = tuple(range(n - k, n))  # parity-heavy: a non-systematic decode
    return rs_code.decode_matrix(n, k, idx)


_jit_gf_ref = jax.jit(jref.gf_matmul_ref)


@pytest.mark.parametrize("L", [1, 511, 512, 1537])
@pytest.mark.parametrize("kind", ["encode", "decode"])
@pytest.mark.parametrize("nk", [(10, 5), (14, 10)])
def test_gf_matmul_ref_matches_reference(nk, kind, L):
    n, k = nk
    M = _matrix(n, k, kind)
    rng = np.random.default_rng(n * 1000 + L)
    data = rng.integers(0, 256, (3, k, L), dtype=np.uint8)
    data[0, :, ::7] = 0  # zero bytes take the special case
    got = ref.gf_matmul_ref(M, torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(got, jrs._gf_matmul_batched_np(M, data))
    if L == 1537:  # one jnp-oracle compile per matrix shape
        np.testing.assert_array_equal(got, np.asarray(_jit_gf_ref(M, data)))


def test_gear_hash_ref_matches_reference():
    """A stream crossing tile seams, starting with zero history."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 3 * gear_cdc.TILE + 17, dtype=np.uint8)
    got = ref.gear_hash_ref(torch.from_numpy(data)).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        got, np.asarray(jops.gear_hash(data, impl="ref")))
    np.testing.assert_array_equal(got,
                                  jchunking.gear_hash_sequential(data))
    np.testing.assert_array_equal(got, chunking.gear_hash_sequential(data))
    # the wrapper pads to the bucket and slices back
    wrapped = gear_cdc.gear_hash(torch.from_numpy(data)).numpy()
    np.testing.assert_array_equal(wrapped.view(np.uint32), got)


@pytest.mark.parametrize("mask", MASKS, ids=["realtime", "archival"])
def test_gear_fire_ref_matches_reference(mask):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 3 * gear_cdc.TILE + 17, dtype=np.uint8)
    got = gear_cdc.gear_fire(torch.from_numpy(data), mask).numpy()
    want = (np.asarray(jops.gear_hash(data, impl="ref")) & mask) == 0
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.bool_ and got.shape == data.shape


def test_sha1_ref_matches_hashlib_and_reference():
    rng = np.random.default_rng(5)
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 55, 56, 63, 64, 119, 8192)]
    blocks, counts = hashing.sha1_pad_batch(msgs)
    words = ref.sha1_ref(torch.from_numpy(blocks.view(np.int32)),
                         torch.from_numpy(counts)).numpy().view(np.uint32)
    assert hashing.digest_words_to_bytes(words) == [
        hashlib.sha1(m).digest() for m in msgs]
    # the reference's eager oracle on the short messages (<= 2 blocks);
    # its jitted form compiles for seconds, and test_torch_ops uses it
    short = [m for m in msgs if len(m) < 120]
    sb, sc = hashing.sha1_pad_batch(short)
    np.testing.assert_array_equal(
        ref.sha1_ref(torch.from_numpy(sb.view(np.int32)),
                     torch.from_numpy(sc)).numpy().view(np.uint32),
        np.asarray(jref.sha1_ref(sb, sc)))


def test_tables_equal_reference():
    """The port's copied constants equal the reference's bit for bit."""
    np.testing.assert_array_equal(chunking.GEAR_TABLE,
                                  jchunking.GEAR_TABLE)
    assert chunking.GEAR_TABLE.dtype == jchunking.GEAR_TABLE.dtype
    np.testing.assert_array_equal(gf256.GF_LOG, jgf256.GF_LOG)
    np.testing.assert_array_equal(gf256.GF_EXP, jgf256.GF_EXP)
    np.testing.assert_array_equal(hashing.SHA1_H0, jhashing.SHA1_H0)
    np.testing.assert_array_equal(hashing.SHA1_K, jhashing.SHA1_K)
    for n, k in [(10, 5), (14, 10)]:
        np.testing.assert_array_equal(rs_code.generator_matrix(n, k),
                                      jrs.generator_matrix(n, k))
        idx = tuple(range(n - k, n))
        np.testing.assert_array_equal(rs_code.decode_matrix(n, k, idx),
                                      jrs.decode_matrix(n, k, idx))


def test_load_tables_from_reference_computes_reference_bytes(default_tables):
    """Loaded from the reference's arrays, the port computes its bytes."""
    t = ops.load_tables(jchunking.GEAR_TABLE, jgf256.GF_LOG, jgf256.GF_EXP,
                        device=CPU)
    assert tables.tables(CPU) is t
    np.testing.assert_array_equal(
        t.gear.numpy().view(np.uint32), jchunking.GEAR_TABLE)
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, 2 * gear_cdc.TILE + 5, dtype=np.uint8)
    np.testing.assert_array_equal(
        ops.gear_hash_stream(data, device=CPU),
        np.asarray(jops.gear_hash_stream(data, impl="ref")))
    G = jrs.generator_matrix(10, 5)
    pieces = rng.integers(0, 256, (2, 5, 700), dtype=np.uint8)
    np.testing.assert_array_equal(
        ops.rs_apply(G, pieces, device=CPU).numpy(),
        np.asarray(jops.rs_apply(G, pieces, impl="ref")))


def test_load_tables_is_what_the_kernels_read(default_tables):
    """Other tables change the results: nothing reads a private copy."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 4096, dtype=np.uint8)
    base = ops.gear_hash_stream(data, device=CPU)
    ops.load_tables(chunking.GEAR_TABLE ^ np.uint32(1), device=CPU)
    assert not np.array_equal(ops.gear_hash_stream(data, device=CPU), base)
    ops.load_tables(device=CPU)
    np.testing.assert_array_equal(ops.gear_hash_stream(data, device=CPU),
                                  base)
    with pytest.raises(ValueError):
        ops.load_tables(chunking.GEAR_TABLE[:10], device=CPU)
