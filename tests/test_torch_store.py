"""The port's store slice, end to end, vs the JAX reference's store.

The same seeded multi-user trace (``repro.core.workload``) runs through
``repro.core.store.SEARSStore(engine="numpy")`` and the port's
``SEARSStore(engine=TorchEngine(device="cpu"))`` -- the plain torch
versions of the kernels behind the port's batched data plane -- with the
port's runtime sanitizer on.  ``tests/differential.replay`` drives both
(it is duck-typed on the store).  Everything observable must be
identical: per-get observations, node piece digests, index records,
listings and ``StoreStats``.  The reference's own tests hold its
``numpy`` and ``ref`` engines byte-identical; one small window also runs
against ``engine="ref"`` (the jitted JAX oracles) to compare launch
counts.
"""

from __future__ import annotations

import dataclasses
import warnings

import pytest
import torch

from differential import artifacts, replay
from repro.core import store as jstore
from repro.core.workload import ShardTraceConfig, multi_shard_trace
from repro.kernels import launches as jlaunches
from repro_torch.core import store as tstore
from repro_torch.core.engine import TorchEngine
from repro_torch.kernels import launches

# 8 ops: 5 puts, 2 gets, 1 delete (overwrites included)
CFG = ShardTraceConfig(n_users=4, n_ops=8, files_per_put=2, file_kb=24,
                       seed=33)
STORE_KW = dict(num_clusters=4, node_capacity=64 << 20)
KILLED = [0, 2, 4, 6, 8]


def _stores(**kw):
    """A reference store on the numpy engine and the port's on torch/CPU."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # n=/k= shim
        ref = jstore.SEARSStore(n=10, k=5, binding="ulb", engine="numpy",
                                **STORE_KW, **kw)
        port = tstore.SEARSStore(n=10, k=5, binding="ulb",
                                 engine=TorchEngine(device="cpu"),
                                 sanitize=True, **STORE_KW, **kw)
    return ref, port


def _assert_identical(ref_store, port_store, ref_obs=(), port_obs=()):
    assert list(port_obs) == list(ref_obs), "per-get observations diverged"
    a, b = artifacts(ref_store), artifacts(port_store)
    for key in ("nodes", "records", "listings"):
        assert b[key] == a[key], f"{key} diverged"
    assert dataclasses.asdict(b["stats"]) == dataclasses.asdict(a["stats"])


def _get_all(store, files) -> list:
    out = []
    for user, names in files.items():
        for blob, st in store.get_files(user, names):
            out.append((blob, dataclasses.astuple(st)))
    return out


@pytest.fixture(scope="module")
def direct_pair():
    """Both stores after a direct replay of the trace (shared by tests
    that continue from that state: degraded get, repair)."""
    ref, port = _stores()
    ops = multi_shard_trace(CFG)
    ref_obs = replay(ref, ops)
    port_obs = replay(port, ops)
    return ref, port, ref_obs, port_obs


def _live_files(store) -> dict:
    return {user: sorted(sw.table)
            for user, sw in sorted(store.switching.items()) if sw.table}


def test_direct_replay_identical(direct_pair):
    ref, port, ref_obs, port_obs = direct_pair
    assert port_obs, "the trace must read something back"
    _assert_identical(ref, port, ref_obs, port_obs)
    assert port._sanitizer is not None and port._sanitizer.checks > 0


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["scheduler", "pipelined"])
def test_scheduler_replay_identical(pipeline):
    ref, port = _stores()
    ops = multi_shard_trace(CFG)
    ref_obs = replay(ref, ops, mode="scheduler", pipeline=pipeline)
    port_obs = replay(port, ops, mode="scheduler", pipeline=pipeline)
    _assert_identical(ref, port, ref_obs, port_obs)


def test_pipelined_get_identical(direct_pair):
    ref, port, _, _ = direct_pair
    files = _live_files(ref)
    assert files == _live_files(port)
    for user, names in files.items():
        a = ref.get_files_pipelined(user, names, window_files=1)
        b = port.get_files_pipelined(user, names, window_files=1)
        assert [(x, dataclasses.astuple(s)) for x, s in b] \
            == [(x, dataclasses.astuple(s)) for x, s in a]


def test_degraded_get_then_repair_identical(direct_pair):
    ref, port, _, _ = direct_pair
    files = _live_files(ref)
    victim = max(port.clusters, key=lambda c: c.used).cluster_id
    assert port.clusters[victim].used > 0
    for s in (ref, port):
        s.clusters[victim].kill_nodes(KILLED)
    before = launches.LAUNCHES.snapshot()
    port_got = _get_all(port, files)
    assert launches.LAUNCHES.delta(before).gf > 0, "no degraded decode ran"
    assert port_got == _get_all(ref, files)
    _assert_identical(ref, port)

    for s in (ref, port):
        s.clusters[victim].replace_nodes(KILLED)
    before = launches.LAUNCHES.snapshot()
    rep_port = port.repair_all()
    d = launches.LAUNCHES.delta(before)
    rep_ref = ref.repair_all()
    assert rep_port.balanced and rep_port.pieces_rebuilt > 0
    assert d.gf >= 2  # one decode and one encode at least
    for f in ("pieces_rebuilt", "pieces_missing", "pieces_failed",
              "pieces_unrecoverable", "rebuilt", "skipped_healthy"):
        assert getattr(rep_port, f) == getattr(rep_ref, f), f
    assert _get_all(port, files) == _get_all(ref, files)
    _assert_identical(ref, port)


def test_window_against_jitted_reference_engine():
    """One small put/get window on ``engine="ref"``: same bytes, same
    LAUNCHES per step.  Four files of one block each: the reference
    compiles its SHA-1 oracle for the (4, 1, 16) shape that
    test_torch_ops also uses."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jstore.SEARSStore(n=10, k=5, binding="ulb", engine="ref",
                                **STORE_KW)
        port = tstore.SEARSStore(n=10, k=5, binding="ulb",
                                 engine=TorchEngine(device="cpu"),
                                 sanitize=True, **STORE_KW)
    files = [(f"f{i}", bytes([i + 1]) * (20 + 9 * i)) for i in range(4)]
    names = [n for n, _ in files]

    def step(fn):
        p0 = launches.LAUNCHES.snapshot()
        b = fn(port)
        dp = launches.LAUNCHES.delta(p0)
        j0 = jlaunches.LAUNCHES.snapshot()
        a = fn(ref)
        dj = jlaunches.LAUNCHES.delta(j0)
        assert dataclasses.asdict(dp) == dataclasses.asdict(dj)
        return a, b

    a, b = step(lambda s: [dataclasses.astuple(x)
                           for x in s.put_files("u", files)])
    assert a == b
    a, b = step(lambda s: [(x, dataclasses.astuple(t))
                           for x, t in s.get_files("u", names)])
    assert a == b and [x for x, _ in b] == [d for _, d in files]
    victim = max(port.clusters, key=lambda c: c.used).cluster_id
    for s in (ref, port):
        s.clusters[victim].kill_nodes(KILLED)
    a, b = step(lambda s: [x for x, _ in s.get_files("u", names)])
    assert a == b == [d for _, d in files]
    _assert_identical(ref, port)


def test_port_store_defaults_to_the_card(monkeypatch):
    """The port's store defaults to the kernel engine on CUDA; without a
    card that raises instead of drifting to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstore.SEARSStore(num_clusters=4)
    assert isinstance(tstore.SEARSStore(num_clusters=4, engine="numpy")
                      .engine, tstore.CodingEngine)
