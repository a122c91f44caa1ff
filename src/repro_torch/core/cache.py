"""Hot-data block cache at the switching node (S3QL-style), with an
async write-back queue.

``BlockCache`` holds *decoded* chunks keyed by ``(chunk_id,
cluster_id)`` -- the same copy identity the chunk index uses, so a
cached blob is always the image of one specific piece set and dedup'd
cross-user reads of the same copy share one entry.  Keys carry the
cluster id (not the control-shard id) because piece placement is what a
hit bypasses; the control-shard *owning* a chunk's metadata still
matters for coherence -- ``SEARSStore.drain_shard`` evicts the drained
shard's entries -- which is what "shard-topology-aware" means here.

Two entry states:

- **clean**: the blob is a read-fill; byte-identical pieces exist on
  the owning cluster.  Clean entries live on an LRU ring bounded by
  ``capacity_bytes`` and are evicted oldest-first.
- **dirty**: the blob was accepted by a write-back ``put`` whose pieces
  have *not* been encoded or stored yet.  Dirty entries are pinned
  (never evicted -- the cache is the only holder of the bytes) and each
  one has a ``WritebackTask`` on the FIFO upload queue plus a capacity
  reservation on its planned cluster, so free-space trajectories match
  the write-through path byte-for-byte.  ``mark_clean`` flips the entry
  once its pieces land; ``discard`` cancels the upload when the chunk
  copy is deleted before it ever reached the cluster.

Crash-consistency rules (the simulator has no real crashes, but the
sanitizer enforces the invariants these rules rest on):

- a write-back ``put`` acknowledges only after the chunk index, file
  meta and cluster reservation are committed -- metadata is never
  dirty, only data;
- dirty bytes are bounded by ``max_dirty_bytes`` (an over-limit commit
  forces a partial synchronous drain);
- ``SEARSStore.flush()``, ``drain_shard`` and ``declare_cluster_lost``
  are drain barriers: no dirty entry survives them (cluster loss
  re-homes dirty chunks planned onto the dying cluster first).

``bandwidth`` (a :class:`repro_torch.core.latency.RepairBandwidth`) meters
drained bytes so background upload traffic floors the retrieval rho of
the clusters it lands on, exactly like repair traffic.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict


@dataclasses.dataclass
class CacheConfig:
    """Policy knobs for :class:`BlockCache`.

    ``capacity_bytes`` bounds clean (evictable) + dirty bytes together;
    dirty bytes are additionally bounded by ``max_dirty_bytes`` (default
    half the capacity) because they are pinned and a full-dirty cache
    could not admit read fills.  ``write_back=False`` gives a pure read
    cache: puts upload synchronously exactly as without a cache.
    """

    capacity_bytes: int = 64 << 20
    write_back: bool = False
    max_dirty_bytes: int | None = None
    bandwidth: object | None = None  # latency.RepairBandwidth or None

    @property
    def dirty_limit(self) -> int:
        if self.max_dirty_bytes is not None:
            return self.max_dirty_bytes
        return self.capacity_bytes // 2


@dataclasses.dataclass
class CacheStats:
    n_hits: int = 0
    n_misses: int = 0
    n_insertions: int = 0
    n_evictions: int = 0
    n_writeback_chunks: int = 0  # chunks drained to their clusters
    n_writeback_failures: int = 0  # drain attempts that were requeued
    writeback_bytes: int = 0  # chunk bytes drained (pre-coding)
    cached_bytes: int = 0  # clean + dirty blob bytes resident now
    dirty_bytes: int = 0  # pinned, upload still queued

    @property
    def hit_ratio(self) -> float:
        return self.n_hits / max(1, self.n_hits + self.n_misses)


@dataclasses.dataclass
class WritebackTask:
    """One queued background upload: a dirty chunk and its plan.

    ``reserved`` is the capacity (``n * piece_len`` bytes) held on
    ``cluster_id`` since plan time; the drain's ``store_chunks`` call
    releases it, a cancel (:meth:`BlockCache.discard`) must release it
    explicitly, and a cluster-loss re-home transfers it.
    """

    chunk_id: bytes
    cluster_id: int
    data: bytes
    piece_len: int
    reserved: int


@dataclasses.dataclass
class _Entry:
    data: bytes
    dirty: bool


class BlockCache:
    """Byte-budgeted LRU of decoded chunks + FIFO write-back queue."""

    def __init__(self, config: CacheConfig | None = None) -> None:
        self.config = config or CacheConfig()
        self.stats = CacheStats()
        # LRU order: oldest first; lookups/fills move_to_end.  Dirty
        # entries sit in the ring too (for deterministic iteration) but
        # the evictor skips them.
        self._entries: OrderedDict[tuple[bytes, int], _Entry] = OrderedDict()
        self._queue: list[WritebackTask] = []  # FIFO, submit order

    # ------------------------------------------------------------ read --
    def lookup(self, chunk_id: bytes, cluster_id: int) -> bytes | None:
        entry = self._entries.get((chunk_id, cluster_id))
        if entry is None:
            self.stats.n_misses += 1
            return None
        self._entries.move_to_end((chunk_id, cluster_id))
        self.stats.n_hits += 1
        return entry.data

    def peek(self, chunk_id: bytes, cluster_id: int) -> bytes | None:
        """Read without touching LRU order or hit/miss stats."""
        entry = self._entries.get((chunk_id, cluster_id))
        return None if entry is None else entry.data

    def is_dirty(self, chunk_id: bytes, cluster_id: int) -> bool:
        entry = self._entries.get((chunk_id, cluster_id))
        return entry is not None and entry.dirty

    def fill(self, chunk_id: bytes, cluster_id: int, data: bytes) -> None:
        """Insert a clean read-fill (no-op if the copy is already cached)."""
        key = (chunk_id, cluster_id)
        if key in self._entries:
            return
        if len(data) > self.config.capacity_bytes:
            return  # larger than the whole budget: never admissible
        self._entries[key] = _Entry(data=data, dirty=False)
        self.stats.cached_bytes += len(data)
        self.stats.n_insertions += 1
        self._evict()

    # ----------------------------------------------------- write-back --
    def put_dirty(self, chunk_id: bytes, cluster_id: int, data: bytes,
                  piece_len: int, reserved: int) -> WritebackTask:
        """Admit a write-back chunk: pinned entry + queued upload."""
        key = (chunk_id, cluster_id)
        if key in self._entries:
            raise RuntimeError(
                f"chunk {chunk_id.hex()} copy on cluster {cluster_id} is "
                "already cached; a second dirty admit would fork its bytes")
        task = WritebackTask(chunk_id=chunk_id, cluster_id=cluster_id,
                             data=data, piece_len=piece_len,
                             reserved=reserved)
        self._entries[key] = _Entry(data=data, dirty=True)
        self._queue.append(task)
        self.stats.cached_bytes += len(data)
        self.stats.dirty_bytes += len(data)
        self.stats.n_insertions += 1
        self._evict()
        return task

    def over_dirty_limit(self) -> bool:
        return self.stats.dirty_bytes > self.config.dirty_limit

    def take_writeback(self, max_bytes: int | None = None
                       ) -> list[WritebackTask]:
        """Dequeue the oldest uploads, at least one, up to ``max_bytes``
        of chunk data.  Entries stay dirty until :meth:`mark_clean`."""
        out: list[WritebackTask] = []
        taken = 0
        while self._queue:
            if out and max_bytes is not None and taken >= max_bytes:
                break
            task = self._queue.pop(0)
            out.append(task)
            taken += len(task.data)
        return out

    def requeue(self, tasks: list[WritebackTask]) -> None:
        """Put failed drain tasks back at the head, original order kept."""
        self._queue[:0] = tasks
        self.stats.n_writeback_failures += len(tasks)

    def mark_clean(self, task: WritebackTask) -> None:
        """The task's pieces landed: unpin its entry (now evictable)."""
        entry = self._entries.get((task.chunk_id, task.cluster_id))
        if entry is None or not entry.dirty:
            raise RuntimeError(
                f"mark_clean for chunk {task.chunk_id.hex()} on cluster "
                f"{task.cluster_id}: no dirty entry (double drain?)")
        entry.dirty = False
        self.stats.dirty_bytes -= len(entry.data)
        self.stats.n_writeback_chunks += 1
        self.stats.writeback_bytes += len(task.data)
        self._evict()

    def discard(self, chunk_id: bytes, cluster_id: int
                ) -> WritebackTask | None:
        """Drop a copy's entry; return its queued upload if it was dirty.

        The caller owns the returned task's cleanup (its cluster
        reservation is still held) -- the canceled upload must never
        run, so it leaves the queue here, atomically with the entry.
        """
        key = (chunk_id, cluster_id)
        entry = self._entries.pop(key, None)
        if entry is None:
            return None
        self.stats.cached_bytes -= len(entry.data)
        if not entry.dirty:
            return None
        self.stats.dirty_bytes -= len(entry.data)
        for i, task in enumerate(self._queue):
            if task.chunk_id == chunk_id and task.cluster_id == cluster_id:
                return self._queue.pop(i)
        raise RuntimeError(
            f"dirty entry for chunk {chunk_id.hex()} on cluster "
            f"{cluster_id} has no queued upload (ledger corruption)")

    def rehome_dirty(self, task: WritebackTask, new_cluster_id: int) -> None:
        """Move a dirty copy's cache key to its re-planned cluster
        (cluster-loss recovery); the task object mutates in place so the
        queue position -- and therefore drain order -- is preserved."""
        old = (task.chunk_id, task.cluster_id)
        entry = self._entries.pop(old)
        task.cluster_id = new_cluster_id
        self._entries[(task.chunk_id, new_cluster_id)] = entry

    def drop_task(self, task: WritebackTask) -> None:
        """Cancel a specific queued upload and its entry (re-home found
        the bytes already live on the target cluster)."""
        self._queue.remove(task)
        entry = self._entries.pop((task.chunk_id, task.cluster_id))
        self.stats.cached_bytes -= len(entry.data)
        self.stats.dirty_bytes -= len(entry.data)

    # ------------------------------------------------------- topology --
    def evict_clean(self, keys: list[tuple[bytes, int]]) -> int:
        """Drop specific clean entries (shard-drain coherence sweep)."""
        dropped = 0
        for key in keys:
            entry = self._entries.get(key)
            if entry is None or entry.dirty:
                continue
            del self._entries[key]
            self.stats.cached_bytes -= len(entry.data)
            self.stats.n_evictions += 1
            dropped += 1
        return dropped

    def cluster_rho(self, cluster_id: int) -> float:
        """Windowed write-back utilisation of a cluster (0 if unmetered)."""
        bw = self.config.bandwidth
        return bw.rho(cluster_id) if bw is not None else 0.0

    def note_drained(self, cluster_id: int, nbytes: int) -> None:
        bw = self.config.bandwidth
        if bw is not None:
            bw.note(cluster_id, nbytes)

    # ---------------------------------------------------- introspection --
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple[bytes, int]) -> bool:
        return key in self._entries

    def keys(self) -> list[tuple[bytes, int]]:
        """Resident copy keys, LRU order (oldest first) -- deterministic."""
        return list(self._entries)

    def entries(self):
        """(key, blob, dirty) triples in LRU order, for the sanitizer."""
        return [(key, e.data, e.dirty) for key, e in self._entries.items()]

    def queued_tasks(self) -> list[WritebackTask]:
        """The pending upload queue, FIFO order (a live view's copy)."""
        return list(self._queue)

    @property
    def dirty_count(self) -> int:
        return len(self._queue)

    # ----------------------------------------------------------- evict --
    def _evict(self) -> None:
        if self.stats.cached_bytes <= self.config.capacity_bytes:
            return
        for key in list(self._entries):
            if self.stats.cached_bytes <= self.config.capacity_bytes:
                break
            entry = self._entries[key]
            if entry.dirty:
                continue  # pinned: the cache is the only holder
            del self._entries[key]
            self.stats.cached_bytes -= len(entry.data)
            self.stats.n_evictions += 1
