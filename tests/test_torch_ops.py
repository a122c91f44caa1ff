"""The port's dispatch layer on CPU tensors vs ``repro.kernels.ops``.

Same inputs, made with numpy from a seed, go through
``repro_torch.kernels.ops`` (``device="cpu"``: the plain torch versions)
and through the JAX reference's ``impl="ref"`` dispatch.  Bytes must be
identical and so must the ``LAUNCHES`` deltas of the same calls.
``TRACES`` are not compared across the packages -- both are
process-global memo/jit caches that earlier tests on a worker change --
but the port must add 0 on a second same-bucket call, as the reference's
own tests assert of its jit cache.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from repro.core import rs_code as jrs
from repro.kernels import launches as jlaunches
from repro.kernels import ops as jops
from repro_torch.core import hashing, rs_code
from repro_torch.core.classes import StorageClass
from repro_torch.kernels import launches, ops

CPU = torch.device("cpu")
CODES = [(10, 5), (14, 10)]


def _blobs(seed: int, lens) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
            for n in lens]


def _both(port_call, ref_call):
    """Run both calls; return their results and LAUNCHES deltas."""
    p0, j0 = launches.LAUNCHES.snapshot(), jlaunches.LAUNCHES.snapshot()
    got = port_call()
    p1 = launches.LAUNCHES.delta(p0)
    want = ref_call()
    j1 = jlaunches.LAUNCHES.delta(j0)
    assert (p1.gf, p1.sha1, p1.gear, p1.fused) \
        == (j1.gf, j1.sha1, j1.gear, j1.fused)
    return got, want


# chunk-sized blobs: 3 piece-length buckets, one of them padded
_LENS = [1, 100, 2559, 2560, 2561, 4096, 5000, 8192, 777, 3000]


@pytest.mark.parametrize("nk", CODES)
def test_rs_encode_blobs_match_reference(nk):
    code, jcode = rs_code.RSCode(*nk), jrs.RSCode(*nk)
    blobs = _blobs(nk[0], _LENS)
    got, want = _both(
        lambda: ops.rs_encode_blobs(code, blobs, device=CPU),
        lambda: jops.rs_encode_blobs(jcode, blobs, impl="ref"))
    assert got == want
    assert got == [code.encode_bytes(b) for b in blobs]


@pytest.mark.parametrize("degraded", [False, True],
                         ids=["systematic", "degraded"])
@pytest.mark.parametrize("nk", CODES)
def test_rs_decode_blobs_match_reference(nk, degraded):
    n, k = nk
    code, jcode = rs_code.RSCode(n, k), jrs.RSCode(n, k)
    blobs = _blobs(n + 1, _LENS)
    enc = [code.encode_bytes(b) for b in blobs]
    rng = np.random.default_rng(n)
    jobs = []
    for b, pieces in zip(blobs, enc):
        keep = (sorted(rng.choice(n, size=k, replace=False)) if degraded
                else range(k))
        jobs.append(({int(i): pieces[i] for i in keep}, len(b)))
    got, want = _both(lambda: ops.rs_decode_blobs(code, jobs, device=CPU),
                      lambda: jops.rs_decode_blobs(jcode, jobs, impl="ref"))
    assert got == want == blobs
    # the split form: begin leaves tensors in flight, finish brings bytes
    state = ops.rs_decode_blobs_begin(code, jobs, device=CPU)
    assert all(torch.is_tensor(t) for t, _ in state[1])
    assert bool(state[1]) == degraded  # systematic arrivals launch nothing
    assert ops.rs_decode_blobs_finish(state) == blobs


@pytest.mark.parametrize("cls", [StorageClass.realtime(),
                                 StorageClass.archival()],
                         ids=["realtime", "archival"])
def test_gear_candidate_positions_match_reference(cls):
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 5 * 8192 + 123, dtype=np.uint8)
    mask = cls.chunker.mask
    got, want = _both(
        lambda: ops.gear_candidate_positions(data, mask, device=CPU),
        lambda: jops.gear_candidate_positions(data, mask, impl="ref"))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64
    fire = ops.gear_fire_issue(data, mask, device=CPU)
    assert torch.is_tensor(fire) and fire.dtype == torch.bool
    np.testing.assert_array_equal(ops.gear_fire_resolve(fire), want)
    assert ops.gear_fire_issue(np.zeros(0, np.uint8), mask,
                               device=CPU) is None


def test_sha1_digests_match_reference():
    # four one-block messages: the (4, 1, 16) launch shape of
    # test_torch_store's ref window, so one process compiles the
    # reference's SHA-1 oracle (seconds on the CPU) once for both
    short = _blobs(9, [0, 20, 54, 55])
    assert hashing.sha1_pad_batch(short)[0].shape == (4, 1, 16)
    got, want = _both(lambda: ops.sha1_digests(short, device=CPU),
                      lambda: jops.sha1_digests(short, impl="ref"))
    assert got == want == [hashlib.sha1(m).digest() for m in short]
    long = _blobs(10, [56, 63, 64, 119, 4096, 8192])
    assert ops.sha1_digests(long, device=CPU) == [
        hashlib.sha1(m).digest() for m in long]


def test_sha1_digest_words_layout():
    """Words come back as (B, 5) int32 bits of the uint32 digest words."""
    msgs = _blobs(12, [3, 60])
    blocks, counts = hashing.sha1_pad_batch(msgs)
    words = ops.sha1_digest_words(blocks, counts, device=CPU)
    assert words.dtype == torch.int32 and words.shape == (2, 5)
    assert hashing.digest_words_to_bytes(ops.words_to_host(words)) == [
        hashlib.sha1(m).digest() for m in msgs]


def test_same_bucket_calls_add_no_traces():
    """A second call in the same bucket adds 0 to every TRACES family."""
    code = rs_code.RSCode(10, 5)
    mask = StorageClass.realtime().chunker.mask
    rng = np.random.default_rng(10)

    def window(seed):
        blobs = _blobs(seed, [3000, 3100, 5000])
        stream = rng.integers(0, 256, 20000 + seed, dtype=np.uint8)
        ops.rs_encode_blobs(code, blobs, device=CPU)
        ops.gear_candidate_positions(stream, mask, device=CPU)
        blocks, counts = hashing.sha1_pad_batch(
            [b"a" * seed, b"b" * (40 + seed)], max_len=120)
        ops.sha1_digest_words(blocks, counts, device=CPU)

    window(1)
    before = launches.TRACES.snapshot()
    window(2)
    d = launches.TRACES.delta(before)
    assert (d.gf, d.sha1, d.gear) == (0, 0, 0)
