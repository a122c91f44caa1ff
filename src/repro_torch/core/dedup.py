"""Deduplication index: chunk ids, reference counts, file chunk-meta-data.

Terminology follows the paper (S II):

* **chunk id** -- SHA-1 digest of the chunk content.
* **file chunk-meta-data** -- ordered list of (chunk_id, cluster_id) entries
  describing one file, held both at the end device and at the user's
  switching node.
* **chunk-meta-data-table** -- per-user map filename -> file chunk-meta-data
  kept by the switching node.
* **reference count** -- number of files a chunk appears in; maintained on
  file add/remove/update.

Index overhead accounting (used by the dedup-ratio metric, which per the
paper *includes indexing overhead*): each unique chunk costs one index
record (digest + cluster id + refcount + length) and each file entry costs
one (digest + cluster id) reference.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

CHUNK_ID_BYTES = 20  # SHA-1
CLUSTER_ID_BYTES = 4
REFCOUNT_BYTES = 4
LENGTH_BYTES = 4

CHUNK_RECORD_BYTES = CHUNK_ID_BYTES + CLUSTER_ID_BYTES + REFCOUNT_BYTES + LENGTH_BYTES
FILE_ENTRY_BYTES = CHUNK_ID_BYTES + CLUSTER_ID_BYTES


@dataclasses.dataclass
class ChunkInfo:
    cluster_id: int
    length: int  # original (un-padded) chunk length in bytes
    refcount: int = 0


@dataclasses.dataclass
class FileMeta:
    """File chunk-meta-data: ordered (chunk_id, cluster_id) entries.

    ``storage_class`` names the :class:`repro_torch.core.classes.StorageClass`
    the file was uploaded under, so retrieval, deletion and repair can
    resolve per-class policy (the code itself always comes from the
    owning cluster of each entry).
    """

    timestamp: float
    entries: list[tuple[bytes, int]]
    lengths: list[int]
    storage_class: str = "default"

    @property
    def size(self) -> int:
        return sum(self.lengths)

    @property
    def meta_bytes(self) -> int:
        return FILE_ENTRY_BYTES * len(self.entries) + 8  # + timestamp


class ChunkIndex:
    """Chunk index with per-cluster copies and refcounting.

    Under CLB a chunk has exactly one copy system-wide; under ULB the *same*
    chunk may be stored independently in several clusters (paper S III:
    cross-cluster redundancy is not exploited), so records are keyed by
    (chunk_id, cluster_id).
    """

    def __init__(self) -> None:
        self._chunks: dict[bytes, dict[int, ChunkInfo]] = {}

    def __contains__(self, chunk_id: bytes) -> bool:
        return chunk_id in self._chunks

    def __len__(self) -> int:
        """Number of stored chunk *copies* (each consumes space)."""
        return sum(len(v) for v in self._chunks.values())

    def get(self, chunk_id: bytes, cluster_id: int | None = None
            ) -> ChunkInfo | None:
        copies = self._chunks.get(chunk_id)
        if not copies:
            return None
        if cluster_id is None:
            return next(iter(copies.values()))
        return copies.get(cluster_id)

    def lookup(self, chunk_id: bytes, scope: Iterable[int] | None = None
               ) -> ChunkInfo | None:
        """Find a stored copy, optionally restricted to a set of clusters.

        ``scope=None`` is the CLB/global view; ULB passes the user's bound
        cluster(s) so cross-cluster redundancy is *not* exploited.
        """
        copies = self._chunks.get(chunk_id)
        if not copies:
            return None
        if scope is None:
            return next(iter(copies.values()))
        for cid in scope:
            if cid in copies:
                return copies[cid]
        return None

    def add(self, chunk_id: bytes, cluster_id: int, length: int) -> ChunkInfo:
        copies = self._chunks.setdefault(chunk_id, {})
        if cluster_id in copies:
            raise KeyError("chunk copy already indexed; use add_ref")
        info = ChunkInfo(cluster_id=cluster_id, length=length, refcount=0)
        copies[cluster_id] = info
        return info

    def add_ref(self, chunk_id: bytes, cluster_id: int, count: int = 1) -> None:
        self._chunks[chunk_id][cluster_id].refcount += count

    def release(self, chunk_id: bytes, cluster_id: int, count: int = 1) -> bool:
        """Drop references; returns True when this copy became garbage."""
        copies = self._chunks[chunk_id]
        info = copies[cluster_id]
        info.refcount -= count
        if info.refcount < 0:
            raise ValueError("refcount underflow")
        if info.refcount == 0:
            del copies[cluster_id]
            if not copies:
                del self._chunks[chunk_id]
            return True
        return False

    def copies(self, chunk_id: bytes) -> tuple[int, ...]:
        """Cluster ids holding an indexed copy of this chunk, sorted.

        Re-placement's donor discovery: under ULB the same content may be
        stored independently on several clusters, and RS pieces are
        content-deterministic, so any copy under the same ``(n, k)`` can
        donate pieces toward a rebuild.
        """
        return tuple(sorted(self._chunks.get(chunk_id, ())))

    def cluster_chunks(self, cluster_id: int) -> set[bytes]:
        return {cid for cid, copies in self._chunks.items()
                if cluster_id in copies}

    def records(self):
        """Iterate all (chunk_id, cluster_id, info) records, insertion order.

        The sanctioned whole-index walk: callers (sanitizer ledger,
        differential artifact dumps) get one stable iteration surface
        that the sharded facade reimplements as a per-shard union, so
        they never reach into ``_chunks`` directly.
        """
        for cid, copies in self._chunks.items():
            for cl, info in copies.items():
                yield cid, cl, info

    @property
    def index_bytes(self) -> int:
        return CHUNK_RECORD_BYTES * len(self)

    def unique_bytes(self) -> int:
        return sum(i.length for v in self._chunks.values()
                   for i in v.values())


def dedup_file(chunk_ids: list[bytes]) -> tuple[list[bytes], list[int]]:
    """Intra-file dedup: unique ids in first-seen order + position map."""
    seen: dict[bytes, int] = {}
    order: list[bytes] = []
    posmap: list[int] = []
    for cid in chunk_ids:
        if cid not in seen:
            seen[cid] = len(order)
            order.append(cid)
        posmap.append(seen[cid])
    return order, posmap
