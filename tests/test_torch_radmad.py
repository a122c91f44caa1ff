"""The port's R-ADMAD baseline against the JAX reference's.

``RADMADStore`` is host code in both packages (numpy RS coding, SHA-1
chunk ids), copied with only its imports changed.  The same trace --
files with shared spans, an overwrite, a delete, container seals, reads
with and without dead nodes -- is replayed into both stores; every
upload, retrieval and store statistic, every byte read back and every
piece on every node must be identical.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest

from repro.core.radmad import RADMADStore as JRADMADStore
from repro_torch.core import RADMADStore


def _blob(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _trace() -> list[tuple]:
    """(op, user, name, data) steps; a quarter of the files' bytes are
    shared spans, so the global dedup has work."""
    shared = _blob(60_000, 99)
    files = {f"f{i}": _blob(90_000 + 7_000 * i, i)[:50_000] + shared
             + _blob(40_000, 50 + i) for i in range(5)}
    ops = [("put", f"u{i % 2}", name, data)
           for i, (name, data) in enumerate(files.items())]
    ops += [("put", "u0", "f0", files["f3"]),  # overwrite, fully deduped
            ("get", "u1", "f1", files["f1"]),
            ("delete", "u1", "f3", None),
            ("flush", None, None, None),
            ("get", "u0", "f0", files["f3"]),
            ("get", "u0", "f2", files["f2"])]
    return ops


def _replay(store, ops) -> list:
    out = []
    for op, user, name, data in ops:
        if op == "put":
            out.append(dataclasses.asdict(store.put_file(user, name, data)))
        elif op == "get":
            got, stats = store.get_file(user, name)
            assert got == data
            out.append(dataclasses.asdict(stats))
        elif op == "delete":
            store.delete_file(user, name)
        else:
            store.flush()
        out.append(dataclasses.asdict(store.stats()))
    return out


def _pieces(store) -> list:
    return [sorted((key, hashlib.sha1(piece).hexdigest())
                   for key, piece in node._pieces.items())
            for cluster in store.clusters for node in cluster.nodes]


@pytest.mark.parametrize("container_kb", [64, 256])
def test_radmad_replay_matches_reference(container_kb):
    kw = dict(num_clusters=3, container_size=container_kb << 10,
              node_capacity=64 << 20, seed=5)
    ref, port = JRADMADStore(**kw), RADMADStore(**kw)
    ops = _trace()
    assert _replay(port, ops) == _replay(ref, ops)
    assert _pieces(port) == _pieces(ref)
    assert ref._next_container > 1  # several containers were sealed

    # degraded reads: every systematic node of every cluster dies, so
    # each sealed container decodes from its parity pieces
    for store in (ref, port):
        for cluster in store.clusters:
            cluster.kill_nodes([0, 1, 2, 3, 4])
    degraded = [("get", "u0", "f2", ops[2][3]), ("get", "u1", "f1", ops[1][3]),
                ("get", "u0", "f0", ops[3][3])]
    assert _replay(port, degraded) == _replay(ref, degraded)
