"""Every store path that a fused engine changes, port vs reference.

Each test runs the same small window through the reference store on
``engine="fused"`` (its jitted ``_fused_ingest_ref`` oracle on the CPU)
and the port's store on ``TorchFusedEngine(device="cpu")`` with the
sanitizer on: a sharded window, a ``BatchScheduler`` flush, a mixed-class
window, a write-back cache window and a failure-storm repair drain.
Node piece digests, index records, listings, ``StoreStats`` and the
``LAUNCHES`` deltas must be identical.  Files are 1 KiB (2 KiB for the
archival class), one chunk each at the chunkers' minimum, and windows
carry at most two chunks per bucket: the reference compiles its SHA-1
loop per launch shape, about 1 s at such batches and 8 s at wider ones.
The port's copy of ``core/workload.py`` is held against the reference's.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from differential import artifacts
from repro.core import store as jstore
from repro.core import workload as jworkload
from repro.core.cache import CacheConfig as JCacheConfig
from repro.core.classes import StorageClass as JStorageClass
from repro.kernels import launches as jlaunches
from repro_torch.core import store as tstore
from repro_torch.core import workload as tworkload
from repro_torch.core.cache import CacheConfig
from repro_torch.core.classes import StorageClass
from repro_torch.core.engine import TorchFusedEngine
from repro_torch.kernels import launches

STORE_KW = dict(num_clusters=4, node_capacity=64 << 20)


def _pair(legacy: bool = True, classes=None, cache=None, **kw):
    """(reference store on ``"fused"``, port store on the fused CPU engine);
    ``classes`` and ``cache`` are (reference, port) pairs."""
    jkw, tkw = dict(STORE_KW, **kw), dict(STORE_KW, **kw)
    if legacy:
        jkw.update(n=10, k=5, binding="ulb")
        tkw.update(n=10, k=5, binding="ulb")
    for key, val in (("classes", classes), ("cache", cache)):
        if val is not None:
            jkw[key], tkw[key] = val
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # n=/k= shim
        jx = jstore.SEARSStore(engine="fused", **jkw)
        pt = tstore.SEARSStore(engine=TorchFusedEngine(device="cpu"),
                               sanitize=True, **tkw)
    return jx, pt


def _both(jx, pt, fn):
    """``fn`` on the port store then the reference; results and the
    ``LAUNCHES`` deltas, which must be equal."""
    p0 = launches.LAUNCHES.snapshot()
    rp = fn(pt)
    dp = dataclasses.asdict(launches.LAUNCHES.delta(p0))
    j0 = jlaunches.LAUNCHES.snapshot()
    rj = fn(jx)
    dj = dataclasses.asdict(jlaunches.LAUNCHES.delta(j0))
    assert dp == dj, f"launches diverged: port {dp}, reference {dj}"
    return rp, rj, dp


def _assert_identical(jx, pt):
    a, b = artifacts(jx), artifacts(pt)
    for key in ("nodes", "records", "listings"):
        assert b[key] == a[key], f"{key} diverged"
    assert dataclasses.asdict(b["stats"]) == dataclasses.asdict(a["stats"])


def _files(seed: int, n: int, size: int = 1024, tag: str = "f"):
    rng = np.random.default_rng(seed)
    return [(f"{tag}{i}", rng.bytes(size)) for i in range(n)]


def _stats(results) -> list:
    return [dataclasses.astuple(s) for s in results]


def test_sharded_window_identical():
    """Two users on different shards in one flush: one fused launch per
    shard sub-window."""
    jx, pt = _pair(shards=2)
    users = [f"user{i}" for i in range(16)]
    a = users[0]
    b = next(u for u in users if jx.shard_map.shard_of_user(u)
             is not jx.shard_map.shard_of_user(a))

    def flush(s):
        sched = s.scheduler()
        futs = [sched.submit_put(a, _files(1, 1)),
                sched.submit_put(b, _files(2, 1))]
        sched.flush()
        return [_stats(f.result()) for f in futs]
    rp, rj, d = _both(jx, pt, flush)
    assert rp == rj
    assert d == dict(gf=0, sha1=0, gear=2, fused=2)
    _assert_identical(jx, pt)


def test_scheduler_flush_identical():
    """Puts of two users and a get coalesce in one flush; the scheduler
    counts the fused launches."""
    jx, pt = _pair()

    def flush(s):
        sched = s.scheduler(pipeline=False)
        puts = [sched.submit_put("u0", _files(3, 1)),
                sched.submit_put("u1", _files(4, 1))]
        sched.flush()
        got = sched.submit_get("u0", ["f0"])
        sched.flush()
        return ([_stats(f.result()) for f in puts],
                [(x, dataclasses.astuple(st)) for x, st in got.result()],
                sched.stats.fused_launches)
    rp, rj, d = _both(jx, pt, flush)
    assert rp == rj and rp[2] == 1
    assert d == dict(gf=0, sha1=0, gear=1, fused=1)
    _assert_identical(jx, pt)


def test_mixed_class_window_identical():
    """Realtime (10,5) and archival (14,10) files in one flush: one gear
    pass per chunker and one fused launch per code."""
    jx, pt = _pair(legacy=False, classes=(
        [JStorageClass.realtime(), JStorageClass.archival()],
        [StorageClass.realtime(), StorageClass.archival()]))

    def flush(s):
        sched = s.scheduler()
        futs = [sched.submit_put("u0", _files(5, 1), storage_class="realtime"),
                sched.submit_put("u1", _files(6, 1, 2048, "c"),
                                 storage_class="archival")]
        sched.flush()
        return [_stats(f.result()) for f in futs]
    rp, rj, d = _both(jx, pt, flush)
    assert rp == rj
    assert d == dict(gf=0, sha1=0, gear=2, fused=2)
    _assert_identical(jx, pt)
    assert [x for x, _ in pt.get_files("u1", ["c0"])] \
        == [_files(6, 1, 2048, "c")[0][1]]


def test_writeback_window_skips_fused():
    """Under write-back the put hashes on the staged path (no fused
    launch, no encode); the drain encodes through GF."""
    jx, pt = _pair(cache=(JCacheConfig(capacity_bytes=1 << 20,
                                       write_back=True),
                          CacheConfig(capacity_bytes=1 << 20,
                                      write_back=True)))
    files = _files(7, 2)
    rp, rj, d = _both(jx, pt, lambda s: _stats(s.put_files("u0", files)))
    assert rp == rj
    assert d == dict(gf=0, sha1=1, gear=1, fused=0)
    rp, rj, d = _both(jx, pt, lambda s: s.flush())
    assert rp == rj == 2
    assert d["gf"] >= 1 and d["fused"] == d["sha1"] == 0
    _assert_identical(jx, pt)
    got, _, _ = _both(jx, pt, lambda s: [x for x, _ in s.get_files(
        "u0", [n for n, _ in files])])
    assert got == [b for _, b in files]


def _report(r) -> tuple:
    return (r.balanced, r.pieces_missing, r.pieces_rebuilt, r.pieces_failed,
            r.pieces_unrecoverable, sorted(r.rebuilt),
            sorted(r.skipped_healthy), sorted(r.unrecoverable))


def test_storm_repair_drain_identical():
    """Fused puts, then a short safe failure storm with a repair pass per
    step: identical reports and artifacts, every file readable."""
    jx, pt = _pair()
    files = {u: _files(10 + i, 2, tag=f"{u}/f") for i, u in
             enumerate(("u0", "u1", "u2"))}
    for user, fl in files.items():
        _both(jx, pt, lambda s: s.put_files(user, fl))
    events = tworkload.failure_storm_trace(
        tworkload.StormConfig(n_clusters=4, n_steps=2, seed=3))
    assert any(ev.kind == "replace" for ev in events)
    rp, rj, d = _both(jx, pt, lambda s: [
        _report(r) for r in tworkload.apply_storm(s, events)])
    assert rp == rj and all(r[0] for r in rp)
    assert sum(r[2] for r in rp) > 0, "the storm rebuilt nothing"
    assert d["fused"] == 0 and d["gf"] >= 2
    _assert_identical(jx, pt)
    for user, fl in files.items():
        assert [x for x, _ in pt.get_files(user, [n for n, _ in fl])] \
            == [b for _, b in fl]


def _plain(obj):
    """Traces as plain values: dataclass events become tuples."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, dataclasses.astuple(obj))
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    return obj


def test_workload_copy_matches_reference():
    small = dict(seed=9)
    pairs = [
        ("multi_user_put_trace", "MultiUserConfig",
         dict(n_users=2, files_per_user=2, file_kb=4, **small)),
        ("streaming_window_trace", "StreamingConfig",
         dict(n_windows=2, users_per_window=2, files_per_user=1, file_kb=4,
              **small)),
        ("mixed_class_trace", "MixedClassConfig",
         dict(n_users=2, hot_kb=4, cold_kb=8, **small)),
        ("multi_shard_trace", "ShardTraceConfig",
         dict(n_users=3, n_ops=12, file_kb=2, add_shard_at=4,
              drain_shard_at=8, **small)),
        ("failure_storm_trace", "StormConfig",
         dict(n_steps=5, cluster_losses=1, racks=2, rack_storm_prob=0.5,
              **small)),
        ("zipf_slo_trace", "SLOTraceConfig",
         dict(n_ops=20, catalog_files=4, file_kb=2, **small)),
    ]
    for fn, cfg, kw in pairs:
        want = getattr(jworkload, fn)(getattr(jworkload, cfg)(**kw))
        got = getattr(tworkload, fn)(getattr(tworkload, cfg)(**kw))
        assert _plain(list(got)) == _plain(list(want)), fn
    wcfg = jworkload.WorkloadConfig(n_users=2, n_days=1, scale=1e-7)
    tcfg = tworkload.WorkloadConfig(n_users=2, n_days=1, scale=1e-7)
    assert _plain(list(tworkload.generate_events(tcfg))) \
        == _plain(list(jworkload.generate_events(wcfg)))
