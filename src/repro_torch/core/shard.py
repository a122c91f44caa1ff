"""Sharded control plane: HSDS-style head/service/data split.

SEARS's switching node owns three metadata structures — the dedup
``ChunkIndex``, the per-user chunk-meta-data tables, and the binding
state — and in the single-node store all three live in one dict each.
This module splits them across N **control shards** the way HSDS splits
an HDF service into headnode / servicenode / datanode roles:

* :class:`ShardMap` — the *headnode* role: shard membership, bucket
  ownership (chunk-id-prefix buckets for the index, user-hash buckets
  for tables and binding entries), and the live add/drain lifecycle
  that migrates bucket state between shards.
* :class:`ControlShard` — the *datanode* role: one shard's slice of the
  chunk index, switching tables, and per-class binding tables.
* :class:`ShardedChunkIndex` / :class:`ShardedSwitchTable` /
  :class:`ShardedBindingSlice` — the *servicenode* role: routing
  facades that present the exact single-node APIs (``ChunkIndex``
  methods, ``MutableMapping``) while resolving every key through the
  owning shard.

**Byte-identity invariant** (proved by ``tests/differential.py``):
sharding is pure *state partitioning*.  Every key maps to a fixed
bucket, buckets map to shards, and lookups route to the current owner,
which holds exactly the state a 1-shard store would hold for those
keys.  No decision — dedup hit, binding assignment, placement, plan
order — depends on the shard count, and add/drain only migrates bucket
state, so an N-shard store is byte-identical to the 1-shard store on
any trace, including traces with mid-flight add/drain.

The one piece of deliberately *head-owned* state is ULB's round-robin
assignment cursor (``UserLevelBinding._next``): sharding the cursor
would make a user's first-write placement a function of the shard
count.  Assignment stays head-sequenced; only the per-user binding
table (``_bound``) is sharded.

Determinism: all cross-shard iteration goes through ``live_ids()``
(sorted) — the searslint plan-determinism pass flags any unsorted
iteration over ``.shards``.
"""

from __future__ import annotations

import hashlib
from collections.abc import MutableMapping
from typing import Iterator

from repro_torch.core import dedup

N_BUCKETS = 64  # fixed key-space partition; ownership maps bucket -> shard


class ControlShard:
    """One shard's slice of the switching node's metadata (datanode role).

    ``index`` holds the chunk records of the shard's chunk-id buckets;
    ``tables`` the switching tables (user -> ``SwitchingNode``) and
    ``bound`` the per-class binding tables (class name -> user ->
    cluster id) of its user buckets.  State always lives with the
    current owner of its bucket — migration on add/drain moves whole
    buckets atomically.
    """

    __slots__ = ("shard_id", "index", "tables", "bound")

    def __init__(self, shard_id: int) -> None:
        self.shard_id = shard_id
        self.index = dedup.ChunkIndex()
        self.tables: dict[str, object] = {}  # user -> SwitchingNode
        self.bound: dict[str, dict[str, int]] = {}  # class -> user -> cluster

    def empty(self) -> bool:
        return (len(self.index) == 0 and not self.tables
                and not any(self.bound.values()))

    def __repr__(self) -> str:
        return (f"ControlShard(id={self.shard_id}, chunks={len(self.index)}, "
                f"users={len(self.tables)})")


class ShardMap:
    """Headnode role: membership, bucket ownership, live add/drain.

    Two fixed key->bucket functions (chunk-id first byte; SHA-1 of the
    user name, first byte) and one dynamic bucket->shard ownership
    vector.  Rebalancing on add/drain moves the minimal number of
    buckets, always in deterministic (bucket index, sorted shard id)
    order, and migrates each bucket's state with it — ownership is
    therefore a pure function of the add/drain history, never of hash
    order.
    """

    def __init__(self, shards: int = 1, n_buckets: int = N_BUCKETS) -> None:
        if shards < 1:
            raise ValueError(f"need at least one shard, got {shards}")
        if shards > n_buckets:
            raise ValueError(f"shards={shards} exceeds the {n_buckets} "
                             "key-space buckets")
        self.n_buckets = n_buckets
        self._next_id = 0
        self.shards: dict[int, ControlShard] = {}
        self._owner: list[int] = []
        for _ in range(shards):
            self.add_shard()

    # ------------------------------------------------------- membership --
    def __len__(self) -> int:
        return len(self.shards)

    def live_ids(self) -> list[int]:
        """Shard ids in service, sorted (the sanctioned iteration order)."""
        return sorted(self.shards)

    def topology(self) -> tuple:
        """Hashable membership + ownership snapshot (sanitizer fingerprint)."""
        return (tuple(self.live_ids()), tuple(self._owner))

    # ---------------------------------------------------------- routing --
    def chunk_bucket(self, chunk_id: bytes) -> int:
        return chunk_id[0] % self.n_buckets

    def user_bucket(self, user: str) -> int:
        return hashlib.sha1(user.encode()).digest()[0] % self.n_buckets

    def shard_of_chunk(self, chunk_id: bytes) -> ControlShard:
        return self.shards[self._owner[self.chunk_bucket(chunk_id)]]

    def shard_of_user(self, user: str) -> ControlShard:
        return self.shards[self._owner[self.user_bucket(user)]]

    # -------------------------------------------------------- lifecycle --
    def _want(self) -> dict[int, int]:
        """Fair bucket share per live shard (first shards absorb remainder)."""
        live = self.live_ids()
        base, extra = divmod(self.n_buckets, len(live))
        return {sid: base + (1 if i < extra else 0)
                for i, sid in enumerate(live)}

    def add_shard(self) -> ControlShard:
        """Bring a fresh shard online; steal its fair bucket share.

        Shard ids are monotonic and never reused — a drained shard's id
        stays retired, so stale references to it can never be confused
        with the newcomer (the "re-admitted with stale metadata" edge).
        Buckets move from over-share owners in bucket-index order,
        carrying their state.
        """
        sid = self._next_id
        self._next_id += 1
        shard = ControlShard(sid)
        self.shards[sid] = shard
        if len(self.shards) == 1:
            self._owner = [sid] * self.n_buckets
            return shard
        want = self._want()
        have = {s: 0 for s in self.live_ids()}
        for o in self._owner:
            have[o] += 1
        for b in range(self.n_buckets):
            if have[sid] >= want[sid]:
                break
            o = self._owner[b]
            if have[o] > want[o]:
                self._move_bucket(b, self.shards[o], shard)
                have[o] -= 1
                have[sid] += 1
        return shard

    def drain_shard(self, shard_id: int) -> None:
        """Take a shard out of service, migrating its buckets to survivors.

        Buckets redistribute in bucket-index order to the sorted
        survivors that are below their fair share, so the resulting
        ownership is deterministic.  The drained shard ends empty; a
        non-empty leftover means state lived off its bucket slice and is
        a routing bug, so it raises.
        """
        if shard_id not in self.shards:
            raise KeyError(f"unknown shard {shard_id}")
        if len(self.shards) == 1:
            raise ValueError("cannot drain the last shard")
        leaving = self.shards.pop(shard_id)
        want = self._want()
        have = {s: 0 for s in self.live_ids()}
        for o in self._owner:
            if o in have:
                have[o] += 1
        targets = self.live_ids()
        ti = 0
        for b in range(self.n_buckets):
            if self._owner[b] != shard_id:
                continue
            while have[targets[ti % len(targets)]] >= \
                    want[targets[ti % len(targets)]]:
                ti += 1
            t = targets[ti % len(targets)]
            self._move_bucket(b, leaving, self.shards[t])
            have[t] += 1
        if not leaving.empty():
            self.shards[shard_id] = leaving  # restore before failing
            raise RuntimeError(
                f"drain of shard {shard_id} left state behind "
                f"({leaving!r}); a key was stored off its bucket owner")

    def _move_bucket(self, bucket: int, src: ControlShard,
                     dst: ControlShard) -> None:
        """Migrate one bucket's ownership and state from src to dst."""
        self._owner[bucket] = dst.shard_id
        for cid in [c for c in src.index._chunks
                    if self.chunk_bucket(c) == bucket]:
            dst.index._chunks[cid] = src.index._chunks.pop(cid)
        for user in [u for u in src.tables
                     if self.user_bucket(u) == bucket]:
            dst.tables[user] = src.tables.pop(user)
        for cls_name, table in src.bound.items():
            dst_table = dst.bound.setdefault(cls_name, {})
            for user in [u for u in table
                         if self.user_bucket(u) == bucket]:
                dst_table[user] = table.pop(user)


class ShardedChunkIndex:
    """``ChunkIndex`` API routed by chunk-id bucket (servicenode role).

    Every lookup — including *global*-scope dedup lookups — resolves
    through the owning shard's slice rather than a store-wide dict:
    cross-pool chunk references under ``dedup="global"`` reach the one
    shard that owns the chunk id, which holds every cluster copy of it
    (copies of one chunk id are never split across shards).
    """

    def __init__(self, shard_map: ShardMap) -> None:
        self._map = shard_map

    def _own(self, chunk_id: bytes) -> dedup.ChunkIndex:
        return self._map.shard_of_chunk(chunk_id).index

    def __contains__(self, chunk_id: bytes) -> bool:
        return chunk_id in self._own(chunk_id)

    def __len__(self) -> int:
        return sum(len(self._map.shards[s].index)
                   for s in self._map.live_ids())

    def get(self, chunk_id: bytes, cluster_id: int | None = None):
        return self._own(chunk_id).get(chunk_id, cluster_id)

    def lookup(self, chunk_id: bytes, scope=None):
        return self._own(chunk_id).lookup(chunk_id, scope)

    def add(self, chunk_id: bytes, cluster_id: int, length: int):
        return self._own(chunk_id).add(chunk_id, cluster_id, length)

    def add_ref(self, chunk_id: bytes, cluster_id: int,
                count: int = 1) -> None:
        self._own(chunk_id).add_ref(chunk_id, cluster_id, count)

    def release(self, chunk_id: bytes, cluster_id: int,
                count: int = 1) -> bool:
        return self._own(chunk_id).release(chunk_id, cluster_id, count)

    def copies(self, chunk_id: bytes) -> tuple[int, ...]:
        return self._own(chunk_id).copies(chunk_id)

    def cluster_chunks(self, cluster_id: int) -> set[bytes]:
        out: set[bytes] = set()
        for sid in self._map.live_ids():
            out |= self._map.shards[sid].index.cluster_chunks(cluster_id)
        return out

    def records(self) -> Iterator[tuple[bytes, int, dedup.ChunkInfo]]:
        """All (chunk_id, cluster_id, info) records, shard id order."""
        for sid in self._map.live_ids():
            yield from self._map.shards[sid].index.records()

    @property
    def index_bytes(self) -> int:
        return dedup.CHUNK_RECORD_BYTES * len(self)

    def unique_bytes(self) -> int:
        return sum(self._map.shards[s].index.unique_bytes()
                   for s in self._map.live_ids())


class ShardedSwitchTable(MutableMapping):
    """user -> ``SwitchingNode`` mapping routed by user bucket."""

    def __init__(self, shard_map: ShardMap) -> None:
        self._map = shard_map

    def _own(self, user: str) -> dict:
        return self._map.shard_of_user(user).tables

    def __getitem__(self, user: str):
        return self._own(user)[user]

    def __setitem__(self, user: str, sw) -> None:
        self._own(user)[user] = sw

    def __delitem__(self, user: str) -> None:
        del self._own(user)[user]

    def __iter__(self) -> Iterator[str]:
        for sid in self._map.live_ids():
            yield from self._map.shards[sid].tables

    def __len__(self) -> int:
        return sum(len(self._map.shards[sid].tables)
                   for sid in self._map.live_ids())


class ShardedBindingSlice(MutableMapping):
    """One storage class's user -> cluster binding table, shard-routed.

    Plugged in as ``UserLevelBinding._bound`` so each user's binding
    entry lives on their owning control shard; reads never create
    state (important: the sanitizer fingerprints binding state inside
    begin-purity guards).
    """

    def __init__(self, shard_map: ShardMap, class_name: str) -> None:
        self._map = shard_map
        self._cls = class_name

    def __getitem__(self, user: str) -> int:
        table = self._map.shard_of_user(user).bound.get(self._cls)
        if table is None or user not in table:
            raise KeyError(user)
        return table[user]

    def __setitem__(self, user: str, cluster_id: int) -> None:
        shard = self._map.shard_of_user(user)
        shard.bound.setdefault(self._cls, {})[user] = cluster_id

    def __delitem__(self, user: str) -> None:
        table = self._map.shard_of_user(user).bound.get(self._cls)
        if table is None or user not in table:
            raise KeyError(user)
        del table[user]

    def __iter__(self) -> Iterator[str]:
        for sid in self._map.live_ids():
            yield from self._map.shards[sid].bound.get(self._cls, ())

    def __len__(self) -> int:
        return sum(len(self._map.shards[sid].bound.get(self._cls, ()))
                   for sid in self._map.live_ids())
