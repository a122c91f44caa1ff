"""The port's fused ingest (kernel K5) vs the JAX reference, on the CPU.

The same seeded blobs go through the reference's
``repro.kernels.ops.fused_hash_encode_blobs(..., impl="ref")`` (the
jitted ``_fused_ingest_ref`` oracle) and the port's
``ops.fused_hash_encode_blobs(..., device="cpu")`` (the plain version of
``csrc/fused_ingest.cu``, which pads SHA-1 messages from the packed
bytes itself).  Ids, pieces and the ``LAUNCHES`` / ``TRACES`` deltas must
be identical.  Then a port store on ``TorchFusedEngine(device="cpu")``
replays a trace beside the reference store on ``engine="fused"``.

The reference's jitted SHA-1 loop compiles per launch shape, about 1 s
for a batch of at most two and 8 s for more, so every bucket here holds
at most two rows and the store traces put files of one chunk each.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings

import numpy as np
import pytest
import torch

from differential import artifacts, replay
from repro.core import hashing as jhashing
from repro.core import store as jstore
from repro.core.engine import FusedEngine
from repro.core.rs_code import RSCode as JRSCode
from repro.core.workload import ShardTraceConfig, multi_shard_trace
from repro.kernels import launches as jlaunches
from repro.kernels import ops as jops
from repro_torch.core import hashing, rs_code
from repro_torch.core import store as tstore
from repro_torch.core.engine import TorchFusedEngine
from repro_torch.core.rs_code import RSCode
from repro_torch.kernels import launches, ops, ref

# Blob lengths per call, by code; ``"dup"`` repeats the call's previous
# blob.  (10,5): the padding edges 0, 1, 55, 56, 63 and 64 bytes, then a
# duplicate beside exactly k*L bytes for L = 1024 in a second bucket
# (whose SHA-1 block axis the k*Lp cap clamps).  (14,10): the same with
# k*L for L = 1024.  Every bucket holds at most two rows: four launch
# shapes in all, one per code and bucket.
CALLS = {
    (10, 5): [[0, 64], [1, 63], [55, 56], [64, "dup", 5 * 1024]],
    (14, 10): [[64, "dup", 10 * 1024]],
}
STORE_KW = dict(num_clusters=4, node_capacity=64 << 20)


def _blobs(spec: list, rng: np.random.Generator) -> list[bytes]:
    out: list[bytes] = []
    for n in spec:
        out.append(out[-1] if n == "dup" else rng.bytes(n))
    return out


def _clear_fused_shapes() -> None:
    """Forget every fused launch shape on both sides, so the next call's
    ``TRACES.fused`` counts its shapes whatever ran before in the process."""
    jops._fused_ingest_ref.clear_cache()
    ops._SEEN_SHAPES.difference_update(
        {key for key in ops._SEEN_SHAPES if key[0] == "fused"})


def _deltas(fn):
    """Run ``fn`` once; its result with both packages' counter deltas."""
    p0, j0 = launches.snapshot_all(), jlaunches.snapshot_all()
    out = fn()
    dp, dj = launches.delta_all(p0), jlaunches.delta_all(j0)
    return out, ({k: dataclasses.asdict(v) for k, v in dp.items()},
                 {k: dataclasses.asdict(v) for k, v in dj.items()})


@pytest.fixture(scope="module")
def dispatched():
    """Every call of ``CALLS`` through both dispatch layers, twice (the
    second pass must retrace nothing); shared by the dispatch tests."""
    _clear_fused_shapes()
    rng = np.random.default_rng(12)
    out = []
    for (n, k), calls in CALLS.items():
        for spec in calls:
            blobs = _blobs(spec, rng)
            runs = []
            for _ in range(2):
                (pt, jx), (dp, dj) = _deltas(lambda: (
                    ops.fused_hash_encode_blobs(RSCode(n, k), blobs,
                                                device="cpu"),
                    jops.fused_hash_encode_blobs(JRSCode(n, k), blobs,
                                                 impl="ref")))
                runs.append((pt, jx, dp, dj))
            out.append(((n, k), blobs, runs))
    return out


def test_fused_dispatch_matches_reference(dispatched):
    for (n, k), blobs, runs in dispatched:
        for pt, jx, _, _ in runs:
            assert pt[0] == jx[0], f"ids diverged for {(n, k)}"
            assert pt[1] == jx[1], f"pieces diverged for {(n, k)}"
        ids, pieces = runs[0][0]
        assert ids == [hashlib.sha1(b).digest() for b in blobs]
        assert pieces == [RSCode(n, k).encode_bytes(b) for b in blobs]


def test_fused_dispatch_counts_match_reference(dispatched):
    """``LAUNCHES``: one fused per bucket and nothing else.  ``TRACES``:
    the first pass ticks once per new (batch, block width, length) shape
    on both sides, the repeated pass ticks nothing."""
    total = 0
    for (n, k), blobs, runs in dispatched:
        buckets = len({-(-RSCode(n, k).piece_len(len(b)) // 512)
                       for b in blobs})
        for i, (_, _, dp, dj) in enumerate(runs):
            assert dp == dj, f"counter deltas diverged for {(n, k)} {i}"
            assert dp["launches"] == dict(gf=0, sha1=0, gear=0,
                                          fused=buckets)
            if i:
                assert dp["traces"]["fused"] == 0
        total += runs[0][2]["traces"]["fused"]
    assert total == 4, "each new launch shape traces once"


def test_block_width_is_the_references():
    """The ``TRACES`` key's block width is what ``sha1_pad_batch`` with
    the bucket's ``k * Lp`` cap gives -- computed without the blocks."""
    for lens, cap in (([0], 2560), ([55, 56], 2560), ([2560, 100], 2560),
                      ([2561, 0, 0], 5120), ([10240], 10240)):
        blocks, _ = jhashing.sha1_pad_batch([b"\0" * n for n in lens],
                                            max_len=cap)
        assert ops._sha1_block_width(lens, cap) == blocks.shape[1]


def test_plain_version_equals_sha1_and_gf_refs():
    """``ref.fused_ingest_ref`` pads from the packed bytes: equal to
    ``sha1_ref`` over ``sha1_pad_batch`` blocks and to ``gf_matmul_ref``,
    with piece lengths that are not multiples of 4 and pad rows."""
    rng = np.random.default_rng(3)
    code, Lp = RSCode(10, 5), 1024
    lens = [0, 1, 55, 56, 63, 64, 5 * 1024, 2561, 3333, 4097, 120, 119]
    blobs = [rng.bytes(n) for n in lens] + [b""] * 4  # pad rows
    plens = [code.piece_len(len(b)) for b in blobs]
    data = torch.from_numpy(np.stack([
        rs_code.pack_blob(b, code.k, L, Lp) for b, L in zip(blobs, plens)]))
    nbytes = torch.tensor([len(b) for b in blobs], dtype=torch.int32)
    G = torch.from_numpy(rs_code.generator_matrix(10, 5).astype(np.uint8))
    words, enc = ref.fused_ingest_ref(G, data, nbytes,
                                      torch.tensor(plens, dtype=torch.int32))
    blocks, counts = hashing.sha1_pad_batch(blobs, max_len=code.k * Lp)
    want = ref.sha1_ref(torch.from_numpy(blocks.view(np.int32)),
                        torch.from_numpy(counts))
    assert torch.equal(words, want)
    assert torch.equal(enc, ref.gf_matmul_ref(G, data))
    assert hashing.digest_words_to_bytes(words.numpy().view(np.uint32)) \
        == [hashlib.sha1(b).digest() for b in blobs]


def test_engine_coalesces_duplicates_like_reference():
    """Same (code, blob) jobs cost one lane on both engines; value-equal
    codes coalesce."""
    rng = np.random.default_rng(4)
    a, b = rng.bytes(55), rng.bytes(64)  # a launch shape met above
    jobs = [(RSCode(10, 5), a), (RSCode(10, 5), b), (RSCode(10, 5), a)]
    jjobs = [(JRSCode(c.n, c.k), blob) for c, blob in jobs]
    (pt, jx), (dp, dj) = _deltas(lambda: (
        TorchFusedEngine(device="cpu").hash_encode_blobs_multi(jobs),
        FusedEngine().hash_encode_blobs_multi(jjobs)))
    assert pt == jx
    assert dp["launches"] == dj["launches"] == dict(gf=0, sha1=0, gear=0,
                                                    fused=1)


def _stores(**kw):
    """The reference store on ``engine="fused"`` and the port's on
    ``TorchFusedEngine(device="cpu")`` with the sanitizer on."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # n=/k= shim
        jx = jstore.SEARSStore(n=10, k=5, binding="ulb", engine="fused",
                               **STORE_KW, **kw)
        pt = tstore.SEARSStore(n=10, k=5, binding="ulb",
                               engine=TorchFusedEngine(device="cpu"),
                               sanitize=True, **STORE_KW, **kw)
    return jx, pt


def _assert_identical(jx, pt):
    a, b = artifacts(jx), artifacts(pt)
    for key in ("nodes", "records", "listings"):
        assert b[key] == a[key], f"{key} diverged"
    assert dataclasses.asdict(b["stats"]) == dataclasses.asdict(a["stats"])


# one-chunk files (1 KiB, the realtime chunker's minimum) in puts of two
TRACE = ShardTraceConfig(n_users=3, n_ops=10, files_per_put=2, file_kb=1,
                         seed=5)


def test_fused_store_replay_identical():
    jx, pt = _stores()
    ops_ = multi_shard_trace(TRACE)
    (obs_p, obs_j), (dp, dj) = _deltas(lambda: (replay(pt, ops_),
                                                replay(jx, ops_)))
    assert obs_p == obs_j and obs_p, "per-get observations diverged"
    _assert_identical(jx, pt)
    assert dp["launches"] == dj["launches"]
    assert dp["launches"]["fused"] > 0
    assert dp["launches"]["sha1"] == dp["launches"]["gf"] == 0
    assert pt._sanitizer.checks > 0


def test_fused_pipelined_windows_identical():
    """``put_windows_pipelined``; then the same windows' shapes again
    under new names: no ``TRACES.fused`` on either side."""
    jx, pt = _stores()
    rng = np.random.default_rng(6)

    def windows(tag):
        return [[(f"u{w}", [(f"{tag}/f{w}{i}", rng.bytes(1024))
                            for i in range(2)])] for w in range(2)]
    first = windows("a")
    (sp, sj), (dp, dj) = _deltas(lambda: (
        pt.put_windows_pipelined(first), jx.put_windows_pipelined(first)))
    assert [[dataclasses.astuple(s) for s in w] for w in sp] \
        == [[dataclasses.astuple(s) for s in w] for w in sj]
    assert dp["launches"] == dj["launches"]
    again = windows("b")
    _, (dp, dj) = _deltas(lambda: (pt.put_windows_pipelined(again),
                                   jx.put_windows_pipelined(again)))
    assert dp["traces"]["fused"] == dj["traces"]["fused"] == 0
    assert dp["launches"]["fused"] == 2
    _assert_identical(jx, pt)


def test_custom_hash_fn_takes_the_staged_path():
    def custom(chunk: bytes) -> bytes:
        return hashlib.blake2b(chunk, digest_size=20).digest()

    eng = TorchFusedEngine(hash_fn=custom, device="cpu")
    assert not eng.supports_fused_ingest
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pt = tstore.SEARSStore(n=10, k=5, binding="ulb", engine=eng,
                               hash_fn=custom, sanitize=True, **STORE_KW)
        jx = jstore.SEARSStore(n=10, k=5, binding="ulb",
                               engine=FusedEngine(custom), hash_fn=custom,
                               **STORE_KW)
    files = [(f"f{i}", bytes([i + 1]) * 1500) for i in range(2)]
    _, (dp, dj) = _deltas(lambda: (pt.put_files("u", files),
                                   jx.put_files("u", files)))
    assert dp["launches"] == dj["launches"]
    assert dp["launches"]["fused"] == 0 and dp["launches"]["gf"] == 1
    _assert_identical(jx, pt)
    assert [x for x, _ in pt.get_files("u", ["f0", "f1"])] \
        == [d for _, d in files]
