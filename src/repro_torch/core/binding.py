"""Data-to-cluster binding schemes (paper S III, Fig. 2).

* **CLB** (chunk-level binding): every unique chunk is independently placed
  on the cluster with the most free space (greedy load levelling).  Dedup
  scope is *global* -- a chunk anywhere in SEARS is never stored twice.

* **ULB** (user-level binding): every user is pinned to one cluster; when
  it fills up the user rolls over to a fresh cluster and -- exactly as the
  paper specifies -- dedup scope shrinks to the *current* cluster only, so
  cross-cluster copies of the same chunk may exist.

Schemes are instantiated per storage class and receive only that class's
cluster *pool*, so all bookkeeping is keyed by ``cluster_id`` (stable
across calls), never by position in the passed list -- a pool is an
arbitrary subset of the store's clusters.
"""

from __future__ import annotations

import abc

from repro_torch.core.cluster import Cluster


class BindingScheme(abc.ABC):
    """Decides target clusters and dedup scope for incoming chunks."""

    name: str = "base"

    @abc.abstractmethod
    def choose_cluster(self, user: str, chunk_id: bytes, need_bytes: int,
                       clusters: list[Cluster]) -> Cluster:
        """Cluster that should store a *new* chunk for ``user``."""

    @abc.abstractmethod
    def dedup_scope(self, user: str, clusters: list[Cluster]):
        """None for global dedup, or an iterable of cluster ids."""


class ChunkLevelBinding(BindingScheme):
    """Greedy max-free-space placement with global dedup (archival mode)."""

    name = "clb"

    def choose_cluster(self, user, chunk_id, need_bytes, clusters):
        best = max(clusters, key=lambda c: c.free)
        if best.free < need_bytes:
            raise RuntimeError("SEARS out of storage (CLB)")
        return best

    def dedup_scope(self, user, clusters):
        return None  # global


class UserLevelBinding(BindingScheme):
    """Sticky per-user cluster with rollover (interactive mode)."""

    name = "ulb"

    def __init__(self, storage=None) -> None:
        # `storage` is the per-user binding table; a sharded store passes
        # a routed MutableMapping (repro_torch.core.shard.ShardedBindingSlice)
        # so each user's entry lives on their owning control shard.  The
        # round-robin assignment cursor stays head-owned: sharding the
        # cursor would make first-write placement a function of the
        # shard count and break the N-shard-vs-1-shard byte identity.
        self._bound = {} if storage is None else storage
        self._next = 0

    def _assign(self, user: str, clusters: list[Cluster]) -> int:
        # round-robin initial assignment spreads users evenly; bind by
        # cluster_id so a class pool (a subset of the store's clusters)
        # resolves the same cluster on every call
        cid = clusters[self._next % len(clusters)].cluster_id
        self._next += 1
        self._bound[user] = cid
        return cid

    def current_cluster(self, user: str, clusters: list[Cluster]) -> Cluster:
        cid = self._bound.get(user)
        if cid is None:
            cid = self._assign(user, clusters)
        for c in clusters:
            if c.cluster_id == cid:
                return c
        # the bound cluster left the pool (declared lost after a
        # disaster): re-assign instead of stranding the user -- their
        # surviving data was re-placed, new writes need a live home
        cid = self._assign(user, clusters)
        for c in clusters:
            if c.cluster_id == cid:
                return c
        raise KeyError(f"user {user!r} bound to cluster {cid}, "
                       f"not in this pool")

    def choose_cluster(self, user, chunk_id, need_bytes, clusters):
        cluster = self.current_cluster(user, clusters)
        if cluster.free < need_bytes:
            # rollover: bind the user's *future* files to a fresh cluster
            candidates = [c for c in clusters if c.free >= need_bytes]
            if not candidates:
                raise RuntimeError("SEARS out of storage (ULB)")
            cluster = max(candidates, key=lambda c: c.free)
            self._bound[user] = cluster.cluster_id
        return cluster

    def dedup_scope(self, user, clusters):
        cluster = self.current_cluster(user, clusters)
        return (cluster.cluster_id,)


def make_binding(name: str, storage=None) -> BindingScheme:
    """Build a binding scheme; ``storage`` is an optional per-user table.

    CLB is stateless and ignores ``storage``; ULB adopts it as its
    ``_bound`` map (the sharded store passes a shard-routed mapping).
    """
    name = name.lower()
    if name == "clb":
        return ChunkLevelBinding()
    if name == "ulb":
        return UserLevelBinding(storage=storage)
    raise ValueError(f"unknown binding scheme {name!r}")
