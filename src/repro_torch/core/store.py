"""SEARS public API: a space-efficient, reliable, fast-retrieval store.

Composes the paper's pipeline end to end:

  upload:   CDC chunk -> SHA-1 id -> intra-file dedup (client) ->
            inter-file dedup at the switching node (scope set by the
            storage class) -> (n,k) RS encode at the coding node ->
            one piece per storage node of the bound cluster.

  download: fetch file chunk-meta-data from the switching node -> skip
            chunks already in the device's local store -> k-of-n piece
            reads per missing chunk -> GF(256) decode -> reassemble.

**Storage classes** (the paper's "flexible mixing of different
configurations"): ``SEARSStore(classes=[StorageClass.realtime(),
StorageClass.archival()])`` partitions the clusters into per-class
*pools*; every cluster carries its own ``(n, k)`` and every request picks
its policy with ``storage_class=``.  A file's class lands in its
``FileMeta``, and retrieval / deletion / repair resolve the erasure code
from the *owning cluster* of each chunk -- never from a store-wide
global.  The legacy single-config kwargs (``n=``, ``k=``, ``binding=``,
``chunker=``) still work as a deprecation shim that builds a one-class
store.

Architecture: a **control plane** (``plan_*`` -- dedup lookups,
binding/placement, reservations; pure per-chunk metadata) feeds a
**data plane** (a ``repro_torch.core.engine.CodingEngine`` -- batched CDC
chunking, SHA-1, RS encode, RS decode over bulk bytes; the whole put
window is chunked in one gear pass per chunker config).
``put_files``/``get_files`` amortize one data-plane batch across many
files; a mixed-class window buckets its kernel work by ``(code, padded
length)``, so it still issues O(code buckets x length buckets) GF/SHA-1
launches -- never O(files).  Both engines are byte-identical, so
placement and stats do not depend on the engine choice.

Many *users'* traffic coalesces the same way: ``scheduler()`` returns a
``repro_torch.core.scheduler.BatchScheduler`` whose flush windows share one
data-plane batch across all queued requests (the paper's multi-user
switching node); submits return ``RequestFuture`` handles that resolve at
``flush()``/``poll()``.  ``put_files``/``get_files``/``delete_file`` are
internally just one-request flushes of that machinery
(``_batch_put``/``_batch_get``/``_batch_delete``).

**Sharded control plane** (``SEARSStore(shards=N)``, or the
``SEARS_SHARDS`` env var): the switching node's metadata — chunk index,
per-user chunk-meta-data tables, binding tables — partitions across N
``repro_torch.core.shard.ControlShard`` slices under a headnode-style
``ShardMap`` (chunk-id-prefix buckets for the index, user-hash buckets
for tables; live ``add_shard``/``drain_shard`` migrates bucket state).
Every put/get/delete/repair plan routes through the owning shard via
the ``ShardedChunkIndex``/``ShardedSwitchTable`` facades, and each
flush window's *data-plane* work demuxes into per-shard sub-windows
(one gear/SHA-1/GF batch set per owning shard, issued back-to-back so
the device overlaps them) while control-plane planning and assembly
stay in global submission order — which is what keeps an N-shard store
byte-identical to the 1-shard store (``tests/differential.py`` proves
it).  Per-shard sub-windows keep the launch economics: O(code buckets
x length buckets) launches per shard window, never O(chunks).

Wall-clock retrieval time is simulated by ``repro_torch.core.latency`` (no real
network in this container); byte-level correctness is real -- every piece
is stored, read back and decoded.

**Default engine.** This store defaults to ``engine="kernel"``: the
``TorchEngine`` on the CUDA device, so the default path is the card.  The
JAX reference store (``repro.core.store``) defaults to ``"numpy"``.  The
divergence is deliberate: the port exists to run the data plane on the
GPU, and a default that silently ran on the host would hide a missing
device.  ``engine="numpy"`` and ``engine=TorchEngine(device="cpu")`` are
the explicit host choices; without CUDA the default raises.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np

from repro_torch.core import chunking, dedup, hashing
from repro_torch.core.binding import make_binding
from repro_torch.core.cache import (BlockCache, CacheConfig, CacheStats,
                                    WritebackTask)
from repro_torch.core.chunking import DEFAULT_CHUNKER, Chunker
from repro_torch.core.classes import StorageClass, partition_pools
from repro_torch.core.cluster import Cluster, SwitchingNode
from repro_torch.core.engine import CodingEngine, make_engine
from repro_torch.core.latency import (ClusterShare, LatencyParams, cache_hit_time,
                                      retrieval_time)
from repro_torch.core.pipeline import (EncodeTask, FetchTask, RetrievalPlan,
                                       UploadPlan)
from repro_torch.core.repair import RepairManager, RepairReport
from repro_torch.core.sanitizer import Sanitizer, SanitizerError  # noqa: F401
from repro_torch.core.shard import (ShardedBindingSlice, ShardedChunkIndex,
                                    ShardedSwitchTable, ShardMap)


@dataclasses.dataclass
class UploadStats:
    filename: str
    file_bytes: int
    n_chunks: int
    n_unique_in_file: int
    n_new_chunks: int
    bytes_uploaded: int  # post-dedup bytes sent device -> SEARS
    piece_bytes_written: int  # post-coding bytes written to nodes


@dataclasses.dataclass
class RetrievalStats:
    filename: str
    file_bytes: int
    time_s: float
    n_chunks: int
    n_fetched: int  # unique chunks actually downloaded
    bytes_fetched: int  # wire bytes: k pieces per fetched chunk
    clusters_touched: int
    n_cache_hits: int = 0  # unique chunks served by the block cache


@dataclasses.dataclass
class ClassStats:
    """Per-storage-class slice of :class:`StoreStats`.

    ``piece_bytes``/``index_bytes``/``n_unique_chunks`` are pool-level
    (classes sharing a pool tag share them); ``logical_bytes``/``n_files``
    are tracked exactly per class.  ``meta_bytes`` is this class's share
    of the switching-node tables.
    """

    name: str
    n: int
    k: int
    n_clusters: int
    logical_bytes: int
    piece_bytes: int
    index_bytes: int  # chunk records of the pool + this class's file meta
    n_files: int
    n_unique_chunks: int

    @property
    def redundancy_overhead(self) -> float:
        """Space expansion n/k of the class's erasure code."""
        return self.n / self.k

    @property
    def dedup_ratio(self) -> float:
        """Class metric: original bytes / pool consumption (incl. index)."""
        return self.logical_bytes / max(1, self.piece_bytes
                                        + self.index_bytes)


@dataclasses.dataclass
class StoreStats:
    logical_bytes: int  # total size of all original files (numerator)
    piece_bytes: int  # bytes on storage nodes (post dedup + coding)
    index_bytes: int  # chunk index + chunk-meta-data tables
    n_unique_chunks: int
    n_files: int
    per_class: dict[str, ClassStats] = dataclasses.field(default_factory=dict)
    cache: CacheStats | None = None  # block-cache counters, if enabled

    @property
    def consumed_bytes(self) -> int:
        return self.piece_bytes + self.index_bytes

    @property
    def dedup_ratio(self) -> float:
        """Paper metric: original bytes / SEARS consumption (incl. index)."""
        return self.logical_bytes / max(1, self.consumed_bytes)


@dataclasses.dataclass
class PutWindowState:
    """An issued-but-unfinished put window (``_put_window_begin``).

    ``groups`` is the window's per-shard demux -- ``[(shard_id,
    [request index, ...]), ...]`` sorted by shard id, captured at begin
    time so a shard add/drain between begin and finish cannot re-split
    the in-flight window.  ``pending`` maps each group's shard id to
    the engine's chunking token -- on the kernel engines an in-flight
    device gear launch per shard sub-window; ``error`` records a shared
    begin-phase failure to be raised at finish time.
    """

    requests: list
    validated: list
    req_cls: list
    groups: list
    pending: dict
    error: Exception | None = None


class SEARSStore:
    def __init__(self, n: int | None = None, k: int | None = None,
                 num_clusters: int = 20, node_capacity: int = 1 << 30,
                 binding: str | None = None, chunker: Chunker | None = None,
                 latency: LatencyParams | None = None, seed: int = 0,
                 hash_fn=hashing.chunk_id,
                 engine: str | CodingEngine = "kernel",
                 classes: list[StorageClass] | None = None,
                 sanitize: bool | None = None,
                 repair_bandwidth=None,
                 shards: int | None = None,
                 cache: CacheConfig | bool | None = None) -> None:
        legacy = [kw for kw, v in (("n", n), ("k", k),
                                   ("binding", binding),
                                   ("chunker", chunker))
                  if v is not None]
        if classes:
            if legacy:
                raise ValueError(
                    f"pass classes= or the legacy kwargs {legacy}, not both")
            class_list = list(classes)
        else:
            if legacy:
                warnings.warn(
                    f"SEARSStore({', '.join(legacy)}) single-config kwargs "
                    "are deprecated; pass classes=[StorageClass(...)] "
                    "instead", DeprecationWarning, stacklevel=2)
            ch = chunker if chunker is not None else DEFAULT_CHUNKER
            class_list = [StorageClass(
                name="default", n=10 if n is None else n,
                k=5 if k is None else k,
                chunk_min=ch.min_size, chunk_avg=ch.avg_size,
                chunk_max=ch.max_size,
                binding=binding if binding is not None else "ulb")]

        self.classes: dict[str, StorageClass] = {c.name: c
                                                 for c in class_list}
        self.default_class = class_list[0]
        self.pools = partition_pools(class_list, num_clusters)
        pool_nk = {c.pool_tag: (c.n, c.k) for c in class_list}
        owner = {cid: tag for tag, cids in self.pools.items()
                 for cid in cids}
        self.clusters = [Cluster(i, pool_nk[owner[i]][0], node_capacity,
                                 k=pool_nk[owner[i]][1])
                         for i in range(num_clusters)]
        # pool membership survives declare_cluster_lost (which removes the
        # cluster from self.pools) so stats/repair can still resolve the
        # owning pool of a lost cluster's chunks
        self._cluster_pool: dict[int, str] = dict(owner)
        self._node_capacity = node_capacity
        # sharded control plane: chunk index, switching tables and
        # binding tables partition across ControlShards by key bucket;
        # shards=1 (the default) is the degenerate single-slice case of
        # the same code path.  SEARS_SHARDS provides the default so
        # whole test suites can run sharded unchanged.
        if shards is None:
            shards = int(os.environ.get("SEARS_SHARDS", "1") or "1")
        self.shard_map = ShardMap(shards)
        # per-class binding scheme instances (ULB assignment state is
        # class-local: the same user may bind differently per class);
        # each ULB's per-user table is shard-routed, its round-robin
        # cursor stays head-owned (see repro_torch.core.shard)
        self._bindings = {
            c.name: make_binding(
                c.binding,
                storage=ShardedBindingSlice(self.shard_map, c.name))
            for c in class_list}
        self.index = ShardedChunkIndex(self.shard_map)
        self.switching = ShardedSwitchTable(self.shard_map)
        self.latency = latency or LatencyParams()
        self.rng = np.random.default_rng(seed)
        self.hash_fn = hash_fn
        self.engine = make_engine(engine, hash_fn)
        self.repair = RepairManager(self, sub_batch=self.REPAIR_BATCH,
                                    bandwidth=repair_bandwidth)
        self._logical = {c.name: 0 for c in class_list}
        self._nfiles = {c.name: 0 for c in class_list}
        # hot-data block cache at the switching node (repro_torch.core.cache);
        # default off, opt in per store or suite-wide via SEARS_CACHE=1
        # (the env default enables a write-back cache so both the read
        # and the write path get exercised by sanitized suite runs)
        if cache is None:
            if os.environ.get("SEARS_CACHE", "") not in ("", "0"):
                cache = CacheConfig(write_back=True)
            else:
                cache = False
        if cache is True:
            cache = CacheConfig()
        self.cache: BlockCache | None = (BlockCache(cache) if cache
                                         else None)
        # runtime sanitizer (begin purity, expected-launch model, piece
        # ledger); default off, opt in per store or via SEARS_SANITIZE=1
        if sanitize is None:
            sanitize = os.environ.get("SEARS_SANITIZE", "") not in ("", "0")
        self._sanitizer = Sanitizer(self) if sanitize else None

    # ---------------------------------------------- class/pool resolution --
    def _class(self, name: str | None) -> StorageClass:
        if name is None:
            return self.default_class
        try:
            return self.classes[name]
        except KeyError:
            raise KeyError(f"unknown storage class {name!r}; have "
                           f"{sorted(self.classes)}") from None

    def _pool(self, cls: StorageClass) -> list[Cluster]:
        return [self.clusters[i] for i in self.pools[cls.pool_tag]]

    def _dedup_scope(self, cls: StorageClass, user: str):
        """Chunk-index scope for a class: binding scope, capped to the pool.

        The binding scheme's scope (ULB: the user's bound cluster; CLB:
        global) never escapes the class's pool unless the class opted
        into ``dedup="global"`` -- pools of different classes must not
        dedup against each other by accident.
        """
        scope = self._bindings[cls.name].dedup_scope(user, self._pool(cls))
        if scope is None and cls.dedup != "global":
            scope = self.pools[cls.pool_tag]
        return scope

    @property
    def _write_back(self) -> bool:
        """True when puts acknowledge at cache commit (async upload)."""
        return self.cache is not None and self.cache.config.write_back

    # -- legacy single-config views (the default class's policy) ----------
    @property
    def n(self) -> int:
        return self.default_class.n

    @property
    def k(self) -> int:
        return self.default_class.k

    @property
    def code(self):
        return self.default_class.code

    @property
    def chunker(self) -> Chunker:
        return self.default_class.chunker

    @property
    def binding(self):
        return self._bindings[self.default_class.name]

    @property
    def logical_bytes(self) -> int:
        return sum(self._logical.values())

    @property
    def n_files(self) -> int:
        return sum(self._nfiles.values())

    # ------------------------------------------------------------------
    def _switch(self, user: str) -> SwitchingNode:
        if user not in self.switching:
            self.switching[user] = SwitchingNode(user)
        return self.switching[user]

    # ------------------------------------------------- shard lifecycle ---
    def add_shard(self) -> int:
        """Bring a new control shard online (live scale-out).

        The headnode map rebalances bucket ownership onto the newcomer
        and migrates the affected index/table/binding state; no routing
        decision changes, so traffic in flight (even a begun-but-
        unfinished put window) commits byte-identically.  Returns the
        new shard id.
        """
        return self.shard_map.add_shard().shard_id

    def drain_shard(self, shard_id: int) -> None:
        """Take a control shard out of service (live scale-in).

        Its buckets — with their chunk records, switching tables and
        binding entries — migrate to the surviving shards; the drained
        id is retired forever (a later ``add_shard`` gets a fresh id and
        starts empty, so stale state can never be re-admitted).

        With a block cache installed the drain is a coherence barrier:
        the write-back queue drains fully first (no dirty chunk may
        outlive the shard that owns its metadata bucket), then every
        cached chunk whose bucket lived on the drained shard is evicted
        -- conservative invalidation, so a re-read after the migration
        re-fills from the (unchanged) clusters."""
        if self.cache is not None:
            self.flush()
            doomed = [key for key in self.cache.keys()
                      if (self.shard_map.shard_of_chunk(key[0]).shard_id
                          == shard_id)]
            self.cache.evict_clean(doomed)
        self.shard_map.drain_shard(shard_id)

    def shard_of_user(self, user: str) -> int:
        """Id of the control shard owning a user's tables and bindings."""
        return self.shard_map.shard_of_user(user).shard_id

    def window_shards(self, users) -> list[int]:
        """Sorted owning-shard ids of a window's users (demux preview)."""
        return sorted({self.shard_map.shard_of_user(u).shard_id
                       for u in users})

    def _window_groups(self, requests) -> list[tuple[int, list[int]]]:
        """Demux a window's requests by owning user shard.

        Returns ``[(shard_id, [request index, ...]), ...]`` sorted by
        shard id, submit order kept within each group.  Data-plane
        batches (gear/hash/encode/read/decode) run once per group — the
        per-shard sub-windows — while control-plane planning and
        assembly stay in global submission order, which is what keeps
        an N-shard run byte-identical to the 1-shard run.
        """
        groups: dict[int, list[int]] = {}
        for i, req in enumerate(requests):
            sid = self.shard_map.shard_of_user(req.user).shard_id
            groups.setdefault(sid, []).append(i)
        return sorted(groups.items())

    # ------------------------------------------------------- scheduling ---
    def scheduler(self, queue=None, **kwargs):
        """A ``BatchScheduler`` coalescing many users' traffic on this store.

        Requests submitted to the scheduler share data-plane batches (one
        SHA-1 launch and one GF(256) launch per (code, length) bucket per
        flush window across *all* queued users) while staying
        byte-identical to sequential per-user ``put_files``/``get_files``
        calls.  Submits return :class:`repro_torch.core.scheduler.RequestFuture`
        handles that resolve at ``flush()``/``poll()``.
        """
        from repro_torch.core.scheduler import BatchScheduler
        return BatchScheduler(self, queue=queue, **kwargs)

    def _one_request(self, req) -> None:
        """Raise the failure of a batch-of-one request, if any."""
        if req.error is not None:
            raise req.error

    # ----------------------------------------------------------- upload ---
    def put_file(self, user: str, filename: str, data: bytes,
                 timestamp: float = 0.0,
                 storage_class: str | None = None) -> UploadStats:
        return self.put_files(user, [(filename, data)], timestamp=timestamp,
                              storage_class=storage_class)[0]

    def put_files(self, user: str, files: list[tuple[str, bytes]],
                  timestamp: float = 0.0,
                  storage_class: str | None = None) -> list[UploadStats]:
        """Upload a batch of files under one storage class's policy.

        A one-user flush of the cross-user batch machinery: hashing runs
        as one engine batch over every chunk of every file; the control
        plane then plans the files *in order* (so later files dedup
        against chunks introduced by earlier ones, exactly like
        sequential ``put_file`` calls); finally all new chunks across the
        batch are RS-encoded in one engine batch and landed per cluster
        with the bulk store API.  The call is atomic: any failure rolls
        the whole batch back and re-raises.
        """
        from repro_torch.core.scheduler import PUT, Request
        req = Request(request_id=0, user=user, kind=PUT, files=list(files),
                      timestamp=timestamp, storage_class=storage_class)
        self._batch_put([req])
        self._one_request(req)
        return req.result

    def _batch_put(self, requests) -> None:
        """Shared put window: coalesce many requests' data-plane work.

        Each request (one user's file batch, under one storage class) is
        a unit of atomicity: a plan-phase failure rolls back that request
        alone; an execute failure rolls back exactly the requests whose
        files reference a chunk copy that failed to land.  Surviving
        requests commit as if the failed ones had been issued -- and
        failed -- separately.  Results/errors are recorded on the request
        objects; this method raises nothing per-request.

        Implemented as ``_put_window_begin`` + ``_put_window_finish`` so
        callers that hold several windows (``put_windows_pipelined``, the
        scheduler's pipelined flush) can issue window *i+1*'s device
        chunking pass before window *i*'s host phases complete.
        """
        self._put_window_finish(self._put_window_begin(requests))

    def put_windows_pipelined(self, windows, timestamp: float = 0.0,
                              storage_class: str | None = None
                              ) -> list[list[UploadStats]]:
        """Upload a stream of put windows with double-buffered ingest.

        ``windows`` is an iterable (list or generator, e.g.
        ``repro_torch.core.workload.streaming_window_trace``) of window batches,
        each ``[(user, [(filename, data), ...]), ...]``.  Window *i+1*'s
        device chunking pass is issued before window *i*'s host phases
        (boundary selection, dedup planning, piece writes) run, so on the
        kernel engines the gear launch of the next window overlaps the
        control-plane work of the current one.  Results are byte- and
        stats-identical to sequential ``put_files`` calls per window
        batch (begin touches no store state; all dedup/placement happens
        at finish time in window order).  Returns one flat
        ``[UploadStats]`` list per window, in request order; any request
        failure raises, exactly like ``put_files``.
        """
        from repro_torch.core.scheduler import PUT, Request
        all_reqs: list[list] = []
        prev: PutWindowState | None = None
        for batch in windows:
            reqs = [Request(request_id=i, user=user, kind=PUT,
                            files=list(files), timestamp=timestamp,
                            storage_class=storage_class)
                    for i, (user, files) in enumerate(batch)]
            all_reqs.append(reqs)
            state = self._put_window_begin(reqs)
            if prev is not None:
                self._put_window_finish(prev)
            prev = state
        if prev is not None:
            self._put_window_finish(prev)
        out: list[list[UploadStats]] = []
        for reqs in all_reqs:
            for req in reqs:
                self._one_request(req)
            out.append([s for req in reqs for s in req.result])
        return out

    def _put_window_begin(self, requests) -> "PutWindowState":
        """Validate payloads and *issue* the window's chunking pass.

        Touches no store state (no index/cluster/meta mutation), so a
        later window may begin while an earlier one is still finishing --
        sequential equivalence is preserved because all dedup/placement
        decisions happen at finish time, in window order.  On the kernel
        engines the returned state holds an in-flight device gear launch.

        With the sanitizer on, the begin runs under a control-plane
        fingerprint guard (it must not mutate store state) and the
        window's gear budget — one launch per distinct chunker — is
        recorded up front, before the launch it covers is issued.
        """
        san = self._sanitizer
        if san is None:
            return self._put_window_begin_impl(requests)
        # per-shard launch model: one gear launch per distinct chunker
        # per shard sub-window (each group chunks in its own pass)
        gear = 0
        for _sid, idxs in self._window_groups(requests):
            chunkers = set()
            for i in idxs:
                try:
                    chunkers.add(
                        self._class(requests[i].storage_class).chunker)
                except KeyError:
                    pass  # the impl fails this request; it chunks nothing
            gear += len(chunkers)
        san.add_budget(gear=gear)
        return san.guard_begin("_put_window_begin",
                               self._put_window_begin_impl, requests)

    def _put_window_begin_impl(self, requests) -> "PutWindowState":
        validated: list[list[tuple[str, bytes, np.ndarray]]] = []
        req_cls: list[StorageClass | None] = []
        for req in requests:
            per_file = []
            cls = None
            try:
                cls = self._class(req.storage_class)
                for filename, data in req.files:
                    per_file.append((filename, data,
                                     chunking.as_bytes_array(data)))
            except Exception as exc:
                req.status, req.error = "failed", exc
                per_file = []
            validated.append(per_file)
            req_cls.append(cls)

        # per-shard sub-windows: one chunking pass per owning shard,
        # issued back-to-back (the device overlaps the in-flight gear
        # launches); the demux is captured in the state so a shard
        # add/drain between begin and finish cannot re-split the window
        groups = self._window_groups(requests)
        pending: dict[int, object] = {}
        error = None
        try:
            for sid, idxs in groups:
                jobs = [(req_cls[i].chunker, arr)
                        for i in idxs
                        for _, _, arr in validated[i]]
                pending[sid] = self.engine.chunk_blobs_multi_begin(jobs)
        except Exception as exc:
            error = exc
        return PutWindowState(requests=requests, validated=validated,
                              req_cls=req_cls, groups=groups,
                              pending=pending, error=error)

    def _put_window_finish(self, state: "PutWindowState") -> None:
        """Resolve an issued put window: hash/encode, plan, land pieces.

        With the sanitizer on, the whole finish runs under a launch-
        attribution bracket: the hash/encode dispatches it issues are
        charged to this store's expected-launch ledger.
        """
        if self._sanitizer is None:
            return self._put_window_finish_impl(state)
        with self._sanitizer.tracking():
            return self._put_window_finish_impl(state)

    def _put_window_finish_impl(self, state: "PutWindowState") -> None:
        requests, validated = state.requests, state.validated
        req_cls = state.req_cls
        try:
            if state.error is not None:
                raise state.error
            spans_by_group = {
                sid: self.engine.chunk_blobs_multi_finish(
                    state.pending[sid])
                for sid, _ in state.groups}
        except Exception as exc:
            # shared chunk-pass failure: nothing planned or landed yet --
            # every live request in the window fails (mirrors the shared
            # encode-batch failure path)
            for req in requests:
                if req.error is None:
                    req.status, req.error = "failed", exc
            return

        # scatter each shard sub-window's spans back onto its requests
        spans_of: dict[int, list] = {}  # request index -> per-file spans
        for sid, idxs in state.groups:
            gspans = spans_by_group[sid]
            pos = 0
            for i in idxs:
                spans_of[i] = gspans[pos:pos + len(validated[i])]
                pos += len(validated[i])

        chunked: list[list[tuple[str, bytes, list[tuple[int, int]],
                                 list[bytes]]]] = []
        for i, (req, cls, per_file) in enumerate(
                zip(requests, req_cls, validated)):
            out = []
            for (filename, data, arr), spans in zip(per_file, spans_of[i]):
                chunks = [arr[o:o + l].tobytes() for o, l in spans]
                out.append((filename, data, spans, chunks))
            chunked.append(out)

        # hashing, one batch per shard sub-window -- on a fused engine
        # each group's chunks are hashed AND speculatively RS-encoded in
        # the same device residency (one launch per piece-length bucket
        # per group); pieces for chunks the dedup pass later rejects are
        # simply dropped.  Staged engines hash here and encode in
        # _execute_uploads as before.  Chunk ids are per-chunk
        # deterministic, so the grouping changes launch counts, never
        # bytes.
        precomputed: dict[tuple[int, int, bytes], list[bytes]] | None = None
        # under write-back the ack must not pay the encode: stage hashing
        # here and defer the GF work to the background drain, even on a
        # fused engine (its speculative hash+encode mega-kernel would
        # move the encode back into the foreground put)
        fused = (getattr(self.engine, "supports_fused_ingest", False)
                 and not self._write_back)
        if fused:
            precomputed = {}
        ids_of: dict[int, list[bytes]] = {}  # request index -> flat ids
        try:
            for sid, idxs in state.groups:
                g_chunks: list[bytes] = []
                g_codes: list = []
                for i in idxs:
                    for _, _, _, chunks in chunked[i]:
                        g_chunks.extend(chunks)
                        g_codes.extend([req_cls[i].code] * len(chunks))
                if self._sanitizer is not None:
                    # hash + encode budget per shard sub-window, from the
                    # pre-dedup chunk list (dedup only shrinks the real
                    # launch count below the model); a write-back commit
                    # hashes only -- its GF budget accrues at drain time
                    self._sanitizer.add_put_budget(
                        g_codes, g_chunks, self.engine,
                        staged_hash_only=self._write_back)
                if fused:
                    g_ids, g_pieces = self.engine.hash_encode_blobs_multi(
                        list(zip(g_codes, g_chunks)))
                    precomputed.update(
                        {(code.n, code.k, cid): pieces
                         for code, cid, pieces in zip(g_codes, g_ids,
                                                      g_pieces)})
                else:
                    g_ids = self.engine.hash_chunks(g_chunks)
                pos = 0
                for i in idxs:
                    n = sum(len(chunks) for _, _, _, chunks in chunked[i])
                    ids_of[i] = g_ids[pos:pos + n]
                    pos += n
        except Exception as exc:
            # shared hash batch failure: same blast radius as the chunk
            # pass -- nothing planned yet, fail the whole window
            for req in requests:
                if req.error is None:
                    req.status, req.error = "failed", exc
            return

        # control plane: plan request by request in submit order (so later
        # requests dedup against chunks introduced by earlier ones, exactly
        # like sequential calls -- across shard groups too); a failure
        # unwinds only its own request
        plans_by_req: dict[int, list[UploadPlan]] = {}
        for i, (req, cls, per_file) in enumerate(
                zip(requests, req_cls, chunked)):
            if req.error is not None:
                continue
            plans: list[UploadPlan] = []
            ids_flat = ids_of[i]
            req_pos = 0
            try:
                for filename, data, spans, chunks in per_file:
                    ids = ids_flat[req_pos:req_pos + len(spans)]
                    req_pos += len(spans)
                    plans.append(self._plan_put(
                        req.user, filename, data, spans, ids, chunks,
                        req.timestamp, cls, request_id=req.request_id))
                plans_by_req[req.request_id] = plans
            except Exception as exc:
                # completed plans still hold their reservations (the
                # partial plan cleaned itself up before propagating)
                for p in plans:
                    for t in p.encode_tasks:
                        self.clusters[t.cluster_id].release_reservation(
                            self.clusters[t.cluster_id].n * t.piece_len)
                self._rollback_files(req.user, plans)
                req.status, req.error = "failed", exc

        # data plane: per shard sub-window, one shared encode batch per
        # code + bulk piece writes.  Encoding is content-deterministic,
        # so per-group batches land byte-identical pieces; failed copies
        # union across groups because a request may dedup against a
        # window-mate on another shard.
        live = [r for r in requests if r.error is None]
        failed_copies: set[tuple[bytes, int]] = set()
        write_error: Exception | None = None
        for gi, (sid, idxs) in enumerate(state.groups):
            g_plans = [p for i in idxs
                       if requests[i].error is None
                       for p in plans_by_req[requests[i].request_id]]
            try:
                if self._write_back:
                    fc, we = self._commit_writeback(g_plans)
                else:
                    fc, we = self._execute_uploads(g_plans,
                                                   precomputed=precomputed)
            except Exception as exc:
                # encode-batch failure: this group's reservations are
                # already released; release the not-yet-executed groups'
                # before rolling the whole window back
                for sid2, idxs2 in state.groups[gi + 1:]:
                    for i2 in idxs2:
                        if requests[i2].error is not None:
                            continue
                        for p in plans_by_req[requests[i2].request_id]:
                            for t in p.encode_tasks:
                                cl = self.clusters[t.cluster_id]
                                cl.release_reservation(cl.n * t.piece_len)
                for req in live:
                    self._rollback_files(req.user,
                                         plans_by_req[req.request_id])
                    req.status, req.error = "failed", exc
                return
            failed_copies |= fc
            write_error = write_error or we

        for req in live:
            plans = plans_by_req[req.request_id]
            if failed_copies and any((cid, cl) in failed_copies
                                     for p in plans for cid, cl in p.entries):
                # this request references a chunk copy whose pieces never
                # landed (its own new chunk, or a window-mate's it deduped
                # against) -- roll it back rather than commit dangling meta
                self._rollback_files(req.user, plans)
                req.status, req.error = "failed", write_error
                continue
            req.result = [
                UploadStats(filename=p.filename, file_bytes=p.file_bytes,
                            n_chunks=p.n_chunks,
                            n_unique_in_file=p.n_unique_in_file,
                            n_new_chunks=len(p.encode_tasks),
                            bytes_uploaded=p.bytes_uploaded,
                            piece_bytes_written=sum(
                                self.clusters[t.cluster_id].n * t.piece_len
                                for t in p.encode_tasks))
                for p in plans]
            req.status = "done"

        if self._sanitizer is not None:
            self._sanitizer.check_window("put window")

        # bounded dirty bytes: a commit that blew the budget pays for a
        # partial synchronous drain before its window returns, so the
        # pinned (unevictable) share of the cache stays bounded no
        # matter how bursty the put traffic is
        if self._write_back:
            while self.cache.over_dirty_limit():
                if self.drain_writeback() == 0:
                    break

    def _rollback_files(self, user: str, plans: list[UploadPlan]) -> None:
        """Drop the metadata of planned files after a failure.

        ``_delete_now`` releases the index references; new chunks hit
        refcount zero, which removes their index records and deletes any
        pieces a partially-run execute phase already landed.  A plan whose
        file was since overwritten (its ``entries`` are no longer the live
        meta) is skipped -- its references were already released by the
        overwrite -- so rolling back one request never deletes a
        neighbour's version of the same filename.
        """
        sw = self._switch(user)
        for p in plans:
            meta = sw.table.get(p.filename)
            if meta is not None and meta.entries is p.entries:
                self._delete_now(user, p.filename)

    def _plan_put(self, user: str, filename: str, data: bytes,
                  spans: list[tuple[int, int]], ids: list[bytes],
                  chunks: list[bytes], timestamp: float,
                  cls: StorageClass, request_id: int = -1) -> UploadPlan:
        """Control plane for one file: dedup, placement, metadata.

        All policy comes from ``cls``: its pool bounds placement and (by
        default) dedup scope, its code sizes the pieces, its binding
        scheme picks clusters inside the pool.  Index and chunk-meta-data
        mutations happen here; clusters chosen for new chunks get their
        piece bytes *reserved* so the binding scheme sees the same
        free-space trajectory as the old store-immediately path
        (placement is plan-order deterministic).  A mid-plan failure
        (e.g. out of storage) unwinds this file's own reservations and
        index mutations before propagating.
        """
        sw = self._switch(user)
        if filename in sw.table:
            self._delete_now(user, filename)

        unique_ids, _ = dedup.dedup_file(ids)  # intra-file dedup (client)
        by_id: dict[bytes, bytes] = {}
        for cid, chunk in zip(ids, chunks):
            by_id.setdefault(cid, chunk)

        scope = self._dedup_scope(cls, user)
        code = cls.code
        binding = self._bindings[cls.name]
        pool = self._pool(cls)
        tasks: list[EncodeTask] = []
        resolved: dict[bytes, int] = {}  # chunk id -> cluster holding a copy

        try:
            for cid in unique_ids:
                info = self.index.lookup(cid, scope)  # inter-file dedup
                if info is None:
                    chunk = by_id[cid]
                    piece_len = code.piece_len(len(chunk))
                    cluster = binding.choose_cluster(
                        user, cid, cls.n * piece_len, pool)
                    cluster.reserve(cls.n * piece_len)
                    self.index.add(cid, cluster.cluster_id, len(chunk))
                    tasks.append(EncodeTask(chunk_id=cid, data=chunk,
                                            cluster_id=cluster.cluster_id,
                                            piece_len=piece_len))
                    resolved[cid] = cluster.cluster_id
                else:
                    resolved[cid] = info.cluster_id
                # refcount = #files referencing this copy
                self.index.add_ref(cid, resolved[cid])
        except Exception:
            for t in tasks:
                self.clusters[t.cluster_id].release_reservation(
                    cls.n * t.piece_len)
            for cid, cluster_id in resolved.items():
                self.index.release(cid, cluster_id)  # drops new records
            raise

        entries = [(cid, resolved[cid]) for cid in ids]
        meta = dedup.FileMeta(timestamp=timestamp, entries=entries,
                              lengths=[l for _, l in spans],
                              storage_class=cls.name)
        sw.put_meta(filename, meta)
        self._logical[cls.name] += len(data)
        self._nfiles[cls.name] += 1
        # the plan shares the *same* entries object as the stored meta, so
        # rollback can tell "this file is still my version" by identity
        return UploadPlan(user=user, filename=filename, timestamp=timestamp,
                          file_bytes=len(data), n_chunks=len(ids),
                          n_unique_in_file=len(unique_ids),
                          encode_tasks=tasks, entries=entries,
                          request_id=request_id, storage_class=cls.name)

    def _execute_uploads(self, plans: list[UploadPlan], precomputed=None
                         ) -> tuple[set[tuple[bytes, int]], Exception | None]:
        """Data plane: batched RS encode + bulk per-cluster piece writes.

        Encode jobs are bucketed by the owning cluster's code (one engine
        batch per distinct ``(n, k)``, each internally length-bucketed),
        so a mixed-class window costs O(code buckets x length buckets)
        GF launches.  ``precomputed`` maps ``(n, k, chunk_id)`` to pieces
        a fused hash+encode pass already produced; tasks found there skip
        the encode batch entirely (with a fused engine that is every live
        task, so ``encode_blobs_multi`` sees an empty job list and issues
        nothing).  Returns ``(failed_copies, error)``: the (chunk_id,
        cluster_id) copies whose pieces could not be stored (dead-node
        writes) and the first write error, so the caller can demux the
        failure back to the requests that reference those copies.
        Cluster writes are independent -- one failing cluster never
        aborts the others.  An encode-batch failure raises (after
        releasing all reservations).
        """
        pre = precomputed or {}
        tasks = [t for p in plans for t in p.encode_tasks]
        # a later file in the batch may have overwritten/deleted an earlier
        # one; drop tasks whose chunk copy is no longer indexed
        live = [t for t in tasks
                if self.index.get(t.chunk_id, t.cluster_id) is not None]
        dead = [t for t in tasks
                if self.index.get(t.chunk_id, t.cluster_id) is None]
        for t in dead:
            self.clusters[t.cluster_id].release_reservation(
                self.clusters[t.cluster_id].n * t.piece_len)
        reserved: dict[int, int] = {}
        for t in live:
            reserved[t.cluster_id] = (
                reserved.get(t.cluster_id, 0)
                + self.clusters[t.cluster_id].n * t.piece_len)
        ready: dict[int, list[bytes]] = {}
        to_encode = []
        for i, t in enumerate(live):
            code = self.clusters[t.cluster_id].code
            hit = pre.get((code.n, code.k, t.chunk_id))
            if hit is not None:
                ready[i] = hit
            else:
                to_encode.append((i, t))
        try:
            encoded = self.engine.encode_blobs_multi(
                [(self.clusters[t.cluster_id].code, t.data)
                 for _, t in to_encode])  # coding nodes
        except Exception:
            for cluster_id, nbytes in reserved.items():
                self.clusters[cluster_id].release_reservation(nbytes)
            raise
        for (i, _), pieces in zip(to_encode, encoded):
            ready[i] = pieces
        by_cluster: dict[int, list[tuple[bytes, list[bytes]]]] = {}
        for i, t in enumerate(live):
            by_cluster.setdefault(t.cluster_id, []).append(
                (t.chunk_id, ready[i]))
        failed: set[tuple[bytes, int]] = set()
        error: Exception | None = None
        for cluster_id, items in by_cluster.items():
            try:
                self.clusters[cluster_id].store_chunks(
                    items, min_pieces=self.clusters[cluster_id].k,
                    reserved=reserved.pop(cluster_id, 0))
            except Exception as exc:  # store_chunks released the bytes
                failed.update((cid, cluster_id) for cid, _ in items)
                error = error or exc
        return failed, error

    # ------------------------------------------------------- write-back ---
    def _commit_writeback(self, plans: list[UploadPlan]
                          ) -> tuple[set[tuple[bytes, int]], Exception | None]:
        """Write-back twin of ``_execute_uploads``: cache-commit the new
        chunks and queue their uploads instead of encoding now.

        The put acknowledges here -- metadata (index record, file meta,
        cluster reservation) is already durable from the plan phase, the
        bytes are pinned dirty in the cache, and the reservation is
        *kept* until the background drain lands the pieces, so binding
        decisions see the same free-space trajectory as write-through.
        Nothing can fail: no encode, no node writes.
        """
        tasks = [t for p in plans for t in p.encode_tasks]
        for t in tasks:
            # a later file in the window may have overwritten/deleted an
            # earlier one's chunk before it ever reached the cache; the
            # delete found no entry to discard, so the plan's reservation
            # is still held and must be released here (the write-through
            # twin does the same for its dead tasks)
            if self.index.get(t.chunk_id, t.cluster_id) is None:
                self.clusters[t.cluster_id].release_reservation(
                    self.clusters[t.cluster_id].n * t.piece_len)
                continue
            self.cache.put_dirty(
                t.chunk_id, t.cluster_id, t.data, t.piece_len,
                reserved=self.clusters[t.cluster_id].n * t.piece_len)
        return set(), None

    def drain_writeback(self, max_bytes: int | None = None) -> int:
        """Upload queued write-back chunks (one background flush window).

        Takes the oldest ``max_bytes`` of dirty chunks (at least one),
        encodes them in one bucketed engine batch and lands the pieces
        per cluster with the bulk store API -- the same launch economics
        as a foreground put window, just off the ack path.  A cluster
        whose writes fail gets its tasks requeued (front of the queue,
        order kept) with the reservation re-taken, so the next drain or
        ``flush()`` retries; piece writes are idempotent for identical
        bytes, so a partially-landed retry is safe.  Returns the number
        of chunks that became clean.
        """
        if self.cache is None:
            return 0
        tasks = self.cache.take_writeback(max_bytes)
        if not tasks:
            return 0
        if self._sanitizer is None:
            return self._drain_writeback_impl(tasks)
        with self._sanitizer.tracking():
            return self._drain_writeback_impl(tasks)

    def _drain_writeback_impl(self, tasks: list[WritebackTask]) -> int:
        live: list[WritebackTask] = []
        for t in tasks:
            if self.index.get(t.chunk_id, t.cluster_id) is None:
                # belt and braces: deletes cancel queued uploads via
                # BlockCache.discard, so a dead task here means only
                # that its reservation must not leak
                self.clusters[t.cluster_id].release_reservation(t.reserved)
                continue
            live.append(t)
        jobs = [(self.clusters[t.cluster_id].code, t.data) for t in live]
        if self._sanitizer is not None:
            self._sanitizer.add_writeback_budget(jobs)
        try:
            encoded = self.engine.encode_blobs_multi(jobs)
        except Exception:
            self.cache.requeue(live)
            raise
        by_cluster: dict[int, list[tuple[WritebackTask, list[bytes]]]] = {}
        for t, pieces in zip(live, encoded):
            by_cluster.setdefault(t.cluster_id, []).append((t, pieces))
        drained = 0
        failed: list[WritebackTask] = []
        for cluster_id, group in by_cluster.items():
            cluster = self.clusters[cluster_id]
            try:
                cluster.store_chunks(
                    [(t.chunk_id, pieces) for t, pieces in group],
                    min_pieces=cluster.k,
                    reserved=sum(t.reserved for t, _ in group))
            except Exception:
                # store_chunks released the reservation; the chunks are
                # still dirty, so re-reserve and push the group back
                for t, _ in group:
                    cluster.reserve(t.reserved)
                failed.extend(t for t, _ in group)
                continue
            for t, _ in group:
                self.cache.mark_clean(t)
                self.cache.note_drained(cluster_id, len(t.data))
                drained += 1
        if failed:
            order = {id(t): i for i, t in enumerate(live)}
            failed.sort(key=lambda t: order[id(t)])  # keep FIFO order
            self.cache.requeue(failed)
        if self._sanitizer is not None:
            self._sanitizer.check_window("writeback drain")
        return drained

    def flush(self) -> int:
        """Durability barrier: drain the write-back queue to empty.

        Called directly, by ``BatchScheduler`` teardown paths, and by
        the shard-drain / cluster-loss lifecycle hooks.  Raises if a
        drain pass makes no progress (every cluster refusing writes), so
        a caller can never believe an undrainable store is clean.
        """
        if self.cache is None:
            return 0
        total = 0
        while self.cache.dirty_count:
            n = self.drain_writeback()
            if n == 0:
                raise RuntimeError(
                    f"write-back flush stalled with "
                    f"{self.cache.dirty_count} dirty chunk(s): no target "
                    "cluster is accepting writes")
            total += n
        return total

    # --------------------------------------------------------- download ---
    def get_file(self, user: str, filename: str,
                 local_chunk_ids: set[bytes] | None = None,
                 rho_fn=None,
                 storage_class: str | None = None
                 ) -> tuple[bytes, RetrievalStats]:
        return self.get_files(user, [filename],
                              local_chunk_ids=local_chunk_ids,
                              rho_fn=rho_fn,
                              storage_class=storage_class)[0]

    def get_files(self, user: str, filenames: list[str],
                  local_chunk_ids: set[bytes] | None = None,
                  rho_fn=None,
                  storage_class: str | None = None
                  ) -> list[tuple[bytes, RetrievalStats]]:
        """Retrieve a batch of files with one batched decode per code.

        A one-user flush of the cross-user batch machinery: piece reads
        are bulk per cluster (modeling per-batch parallel node requests
        rather than serial per-chunk fetches) and all non-systematic
        decodes across the batch share engine launches, bucketed by the
        owning cluster's code.  ``storage_class`` is an optional
        assertion: when given, a file stored under a different class
        fails with ``KeyError``.  Any failure (missing file,
        unrecoverable chunk) raises.
        """
        from repro_torch.core.scheduler import GET, Request
        req = Request(request_id=0, user=user, kind=GET,
                      filenames=list(filenames),
                      local_chunk_ids=local_chunk_ids, rho_fn=rho_fn,
                      storage_class=storage_class)
        self._batch_get([req])
        self._one_request(req)
        return req.result

    def get_files_pipelined(self, user: str, filenames: list[str],
                            window_files: int = 4,
                            local_chunk_ids: set[bytes] | None = None,
                            rho_fn=None,
                            storage_class: str | None = None
                            ) -> list[tuple[bytes, RetrievalStats]]:
        """Retrieve many files with a prefetched double-buffered pipeline.

        Files are grouped into windows of ``window_files``; while window
        *i*'s decode launches are in flight on the device, window
        *i+1*'s control-plane work -- ``RetrievalPlan`` construction and
        bulk cluster piece reads -- is issued, and only then is window
        *i* materialized and assembled.  Byte- and stats-identical to
        ``get_files`` over the same filename list (assembly order, and
        therefore the latency-model rng draw order, is filename order in
        both paths); failures raise exactly like ``get_files``.
        """
        windows = [filenames[i:i + window_files]
                   for i in range(0, len(filenames), window_files)]
        out: list[tuple[bytes, RetrievalStats]] = []
        prev = None
        for window in windows:
            state = self._get_window_begin(user, window, local_chunk_ids,
                                           storage_class)
            if prev is not None:
                out.extend(self._get_window_finish(prev, rho_fn))
            prev = state
        if prev is not None:
            out.extend(self._get_window_finish(prev, rho_fn))
        return out

    def _get_window_begin(self, user: str, filenames: list[str],
                          local_chunk_ids: set[bytes] | None,
                          storage_class: str | None):
        """Plan + read one retrieval window and *issue* its decodes.

        Raises on a missing file or an unrecoverable chunk (same errors,
        same messages as ``get_files``); on success returns a state whose
        decode launches are in flight but unmaterialized.
        """
        plans = [self._plan_get(user, fn, local_chunk_ids,
                                storage_class=storage_class)
                 for fn in filenames]
        tasks = [t for p in plans for t in p.fetch_tasks]
        by_cluster: dict[int, list[FetchTask]] = {}
        for t in tasks:
            by_cluster.setdefault(t.cluster_id, []).append(t)
        for cluster_id, ctasks in by_cluster.items():
            got = self._read_cluster_pieces(cluster_id,
                                            [t.chunk_id for t in ctasks])
            for t in ctasks:
                t.pieces = got[t.chunk_id]
        for t in tasks:
            systematic = set(range(self.clusters[t.cluster_id].k))
            if t.pieces is not None and set(t.pieces) != systematic:
                self.repair.hint(t.chunk_id, t.cluster_id)
        for t in tasks:
            want = self.clusters[t.cluster_id].k
            if len(t.pieces) < want:
                raise ValueError(
                    f"need >= k={want} pieces to decode, got "
                    f"{len(t.pieces)} (chunk {t.chunk_id.hex()})")
        uniq: dict[tuple[bytes, int], FetchTask] = {}
        for p in plans:
            for t in p.fetch_tasks:
                uniq.setdefault((t.chunk_id, t.cluster_id), t)
        jobs = [(self.clusters[t.cluster_id].code, t.pieces, t.length)
                for t in uniq.values()]
        if self._sanitizer is not None:
            # at most one GF decode launch per unique chunk (bucketing
            # merges same-(code, length) jobs below this bound); the
            # engine begin itself must not touch store state
            self._sanitizer.add_budget(gf=len(jobs))
            token = self._sanitizer.guard_begin(
                "decode_blobs_multi_begin",
                self.engine.decode_blobs_multi_begin, jobs)
        else:
            token = self.engine.decode_blobs_multi_begin(jobs)
        return (plans, list(uniq), token)

    def _get_window_finish(self, state, rho_fn
                           ) -> list[tuple[bytes, RetrievalStats]]:
        """Materialize an issued retrieval window and assemble its files."""
        plans, keys, token = state
        blobs = self.engine.decode_blobs_multi_finish(token)
        blob_by_key = dict(zip(keys, blobs))
        if self.cache is not None:
            for (cid, cl), blob in blob_by_key.items():
                self.cache.fill(cid, cl, blob)
        out = [self._assemble(
            plan,
            {t.chunk_id: blob_by_key[(t.chunk_id, t.cluster_id)]
             for t in plan.fetch_tasks},
            rho_fn) for plan in plans]
        if self._sanitizer is not None:
            self._sanitizer.check_launches("get window")
        return out

    def _batch_get(self, requests) -> None:
        """Shared get window: coalesce many requests' reads and decodes.

        All requests' missing chunks are fetched with one bulk read per
        cluster and decoded in shared engine batches (one per distinct
        cluster code).  Failures stay per-request: a missing file or an
        unrecoverable chunk (< the owning cluster's k live pieces) fails
        only the request that referenced it -- its jobs are excluded from
        the shared decode so a neighbour's batch is never poisoned.
        Results/errors are recorded on the request objects.
        """
        plans_by_req: dict[int, list[RetrievalPlan]] = {}
        for req in requests:
            try:
                plans_by_req[req.request_id] = [
                    self._plan_get(req.user, fn, req.local_chunk_ids,
                                   request_id=req.request_id,
                                   storage_class=req.storage_class)
                    for fn in req.filenames]
            except Exception as exc:
                req.status, req.error = "failed", exc

        # data plane: per shard sub-window, bulk piece reads per cluster
        # across the group's requests; reads have no store side effects,
        # so an infrastructure failure here fails the window's requests
        # instead of raising out of a flush whose queue was already
        # drained.  The demux keeps per-shard windows' read batches
        # independent while the task list (and therefore the read-repair
        # hint order below) stays in global submission order.
        live = [r for r in requests if r.error is None]
        req_groups: dict[int, list] = {}
        for r in live:
            sid = self.shard_map.shard_of_user(r.user).shard_id
            req_groups.setdefault(sid, []).append(r)
        groups = sorted(req_groups.items())
        try:
            all_tasks = [t for r in live for p in plans_by_req[r.request_id]
                         for t in p.fetch_tasks]
            for sid, greqs in groups:
                by_cluster: dict[int, list[FetchTask]] = {}
                for r in greqs:
                    for p in plans_by_req[r.request_id]:
                        for t in p.fetch_tasks:
                            by_cluster.setdefault(t.cluster_id,
                                                  []).append(t)
                for cluster_id, tasks in by_cluster.items():
                    got = self._read_cluster_pieces(
                        cluster_id, [t.chunk_id for t in tasks])
                    for t in tasks:
                        t.pieces = got[t.chunk_id]
        except Exception as exc:
            for req in live:
                req.status, req.error = "failed", exc
            return

        # read-repair: a non-systematic piece set means a node in the
        # systematic prefix was dead or had lost its piece -- hint the
        # repair queue so hot degraded chunks heal without waiting for a
        # full scan (the hint censuses the chunk and drops false alarms,
        # e.g. a holder that is merely down with its piece intact)
        for t in all_tasks:
            systematic = set(range(self.clusters[t.cluster_id].k))
            if t.pieces is not None and set(t.pieces) != systematic:
                self.repair.hint(t.chunk_id, t.cluster_id)

        # demux data loss to its request before the shared decode so one
        # unrecoverable chunk cannot poison the whole window
        for req in live:
            for p in plans_by_req[req.request_id]:
                for t in p.fetch_tasks:
                    want = self.clusters[t.cluster_id].k
                    if len(t.pieces) < want and req.error is None:
                        req.status = "failed"
                        req.error = ValueError(
                            f"need >= k={want} pieces to decode, got "
                            f"{len(t.pieces)} (chunk {t.chunk_id.hex()})")
        live = [r for r in live if r.error is None]

        # shared decode per shard sub-window, deduplicated within the
        # group and bucketed by the owning cluster's code: a chunk
        # referenced by several of the group's tasks (cross-user or
        # cross-file redundancy) is decoded once and the blob fanned
        # back out to every referencing plan.  Decodes are
        # content-deterministic, so a chunk shared across groups decodes
        # to identical bytes in each.
        blob_by_key: dict[tuple[bytes, int], bytes] = {}
        try:
            for sid, greqs in groups:
                uniq: dict[tuple[bytes, int], FetchTask] = {}
                for req in greqs:
                    if req.error is not None:
                        continue
                    for p in plans_by_req[req.request_id]:
                        for t in p.fetch_tasks:
                            uniq.setdefault((t.chunk_id, t.cluster_id), t)
                jobs = [(self.clusters[t.cluster_id].code, t.pieces,
                         t.length) for t in uniq.values()]
                if self._sanitizer is not None:
                    # same decode model as _get_window_begin, per shard
                    # sub-window: one GF launch per unique chunk is the
                    # ceiling, bucketing stays below
                    self._sanitizer.add_budget(gf=len(jobs))
                    blobs = self._sanitizer.track(
                        self.engine.decode_blobs_multi, jobs)
                else:
                    blobs = self.engine.decode_blobs_multi(jobs)
                blob_by_key.update(zip(uniq, blobs))
        except Exception as exc:
            for req in live:
                req.status, req.error = "failed", exc
            return

        # read-fill: every decoded chunk becomes a clean cache entry (in
        # deterministic plan order), so the next window's repeats hit
        if self.cache is not None:
            for (cid, cl), blob in blob_by_key.items():
                self.cache.fill(cid, cl, blob)

        # assemble + stats per file, fanned back out per request (a bad
        # per-request rho_fn fails only its own request)
        for req in live:
            try:
                out = [self._assemble(
                    plan,
                    {t.chunk_id: blob_by_key[(t.chunk_id, t.cluster_id)]
                     for t in plan.fetch_tasks},
                    req.rho_fn) for plan in plans_by_req[req.request_id]]
            except Exception as exc:
                req.status, req.error = "failed", exc
                continue
            req.result = out
            req.status = "done"

        if self._sanitizer is not None:
            self._sanitizer.check_launches("get window")

    def _read_cluster_pieces(self, cluster_id: int, chunk_ids: list[bytes]
                             ) -> dict[bytes, dict[int, bytes]]:
        """The sanctioned bulk piece-read path for cache *misses*.

        Every hot-path cluster read funnels through here so the block
        cache's accounting stays honest: hits were peeled off in
        ``_plan_get``, so by construction each byte read here was a
        cache miss.  searslint's cache-discipline pass flags any other
        ``read_pieces*`` call in store/scheduler hot paths.
        """
        cluster = self.clusters[cluster_id]
        return cluster.read_pieces_batch(chunk_ids, cluster.k)

    def _plan_get(self, user: str, filename: str,
                  local_chunk_ids: set[bytes] | None,
                  request_id: int = -1,
                  storage_class: str | None = None) -> RetrievalPlan:
        """Control plane: meta lookup + unique-missing-chunk fetch list.

        Per-chunk piece lengths come from the *owning cluster's* code --
        under mixed classes (or global-scope dedup) one file may
        reference chunks living under different ``(n, k)``.
        """
        sw = self._switch(user)
        meta = sw.get_meta(filename)
        if storage_class is not None and meta.storage_class != storage_class:
            raise KeyError(
                f"{filename!r} is stored under class "
                f"{meta.storage_class!r}, not {storage_class!r}")
        local = local_chunk_ids or set()

        tasks: list[FetchTask] = []
        share_bytes: dict[int, int] = {}
        cached: dict[bytes, bytes] = {}
        seen: set[bytes] = set()
        for cid, cluster_id in meta.entries:
            if cid in local or cid in seen:
                continue
            seen.add(cid)
            info = self.index.get(cid, cluster_id)
            if info is None:
                raise KeyError(f"chunk {cid.hex()} lost from index")
            if self.cache is not None:
                blob = self.cache.lookup(cid, cluster_id)
                if blob is not None:
                    # hit: never becomes a fetch task, never touches the
                    # cluster.  A dirty copy (write-back not yet drained)
                    # always lands here -- it is pinned in the cache and
                    # its pieces do not exist anywhere else yet.
                    cached[cid] = blob
                    continue
            tasks.append(FetchTask(
                chunk_id=cid, cluster_id=cluster_id, length=info.length,
                piece_len=self.clusters[cluster_id].code.piece_len(
                    info.length)))
            share_bytes[cluster_id] = (share_bytes.get(cluster_id, 0)
                                       + info.length)
        return RetrievalPlan(user=user, filename=filename, meta=meta,
                             fetch_tasks=tasks, share_bytes=share_bytes,
                             request_id=request_id, cached=cached)

    def _assemble(self, plan: RetrievalPlan, decoded: dict[bytes, bytes],
                  rho_fn) -> tuple[bytes, RetrievalStats]:
        meta = plan.meta
        out = bytearray()
        for (cid, cluster_id), ln in zip(meta.entries, meta.lengths):
            blob = decoded.get(cid)
            if blob is None:
                blob = plan.cached.get(cid)
            if blob is None:
                blob = self._read_local_placeholder(cid, cluster_id, ln)
            out += blob[:ln]

        cls = self.classes.get(meta.storage_class, self.default_class)
        # repair/scrub traffic congests the clusters it reads/writes: with
        # a RepairBandwidth installed, its per-cluster utilisation floors
        # the rho each retrieval connection sees (max with any caller-
        # provided rho_fn).  Without one, behavior is unchanged (rho 0).
        # Background write-back drains congest their target clusters the
        # same way (the cache's own bandwidth meter).
        wb_rho = (self.cache.cluster_rho if self.cache is not None
                  else self.repair.cluster_rho)
        shares = [ClusterShare(cl, nb,
                               rho=max(rho_fn(cl) if rho_fn else 0.0,
                                       self.repair.cluster_rho(cl),
                                       wb_rho(cl)))
                  for cl, nb in plan.share_bytes.items()]
        t = retrieval_time(shares, cls.n, cls.k, self.latency, self.rng)
        if plan.cached:
            # cached bytes bypass the retrieval model: they stream from
            # the switching node at client NIC rate.  retrieval_time([])
            # is the same meta_rtt that cache_hit_time charges, so a
            # full hit costs exactly cache_hit_time(cached_bytes).
            t += (cache_hit_time(plan.cached_bytes, self.latency)
                  - self.latency.meta_rtt)
        stats = RetrievalStats(filename=plan.filename, file_bytes=meta.size,
                               time_s=t, n_chunks=len(meta.entries),
                               n_fetched=len(plan.fetch_tasks),
                               bytes_fetched=plan.wire_bytes,
                               clusters_touched=len(plan.share_bytes),
                               n_cache_hits=len(plan.cached))
        return bytes(out), stats

    def _read_local_placeholder(self, cid: bytes, cluster_id: int,
                                length: int) -> bytes:
        """Local-cache hit: the device already holds the chunk.

        The simulator does not persist device caches, so rebuild the chunk
        from SEARS with the owning cluster's code (time is *not* charged
        -- it was a cache hit).  The block cache is peeked first: a
        dirty write-back chunk has no pieces on any cluster yet, so the
        cache copy is the only source of its bytes."""
        if self.cache is not None:
            blob = self.cache.peek(cid, cluster_id)
            if blob is not None:
                return blob
        cluster = self.clusters[cluster_id]
        pieces = cluster.read_pieces(cid, cluster.k)  # searslint: ignore[cache-bypass] -- device local-cache rebuild; cache peeked above, no time charged
        return cluster.code.decode_bytes(pieces, length)

    # ------------------------------------------------------------ delete ---
    def delete_file(self, user: str, filename: str) -> None:
        """Delete one file: a one-request flush of the DELETE machinery.

        Deletes submitted through a scheduler (``submit_delete``)
        serialize with queued puts/gets in submission order; this direct
        call is the batch-of-one special case, exactly like ``put_file``.
        """
        from repro_torch.core.scheduler import DELETE, Request
        req = Request(request_id=0, user=user, kind=DELETE,
                      filenames=[filename])
        self._batch_delete([req])
        self._one_request(req)

    def _batch_delete(self, requests) -> None:
        """Shared delete window: apply each request's deletes in order.

        Deletion is pure control-plane work (refcounts, index records,
        piece drops), so there is nothing to coalesce on the data plane
        -- the window exists so deletes *serialize* with put/get windows
        in submission order.  A missing file fails only its own request;
        files already deleted by that point stay deleted (deletion is not
        transactional across a request's filename list).
        """
        for req in requests:
            deleted: list[str] = []
            try:
                for fn in req.filenames:
                    self._delete_now(req.user, fn)
                    deleted.append(fn)
            except Exception as exc:
                req.status, req.error = "failed", exc
                continue
            req.result = deleted
            req.status = "done"

    def _delete_now(self, user: str, filename: str) -> None:
        """Immediate delete: drop meta, release refs, free garbage chunks."""
        sw = self._switch(user)
        meta = sw.drop_meta(filename)
        cls_name = (meta.storage_class if meta.storage_class in self._logical
                    else self.default_class.name)
        self._logical[cls_name] -= meta.size
        self._nfiles[cls_name] -= 1
        seen: set[tuple[bytes, int]] = set()
        for cid, cluster_id in meta.entries:
            if (cid, cluster_id) in seen:
                continue
            seen.add((cid, cluster_id))
            if self.index.release(cid, cluster_id):
                # last reference gone: cancel any queued write-back of
                # this copy atomically with dropping its pieces, and
                # hand back the cluster capacity the plan reserved.  The
                # delete_chunk still runs (idempotent) because a partial
                # drain failure may have landed pieces while the task
                # stayed queued.
                if self.cache is not None:
                    task = self.cache.discard(cid, cluster_id)
                    if task is not None:
                        self.clusters[cluster_id].release_reservation(
                            task.reserved)
                self.clusters[cluster_id].delete_chunk(cid)

    # ------------------------------------------------- disaster recovery --
    def pool_of(self, cluster_id: int) -> str:
        """Pool tag a cluster belongs (or belonged, if lost) to."""
        return self._cluster_pool[cluster_id]

    def declare_cluster_lost(self, cluster_id: int) -> int:
        """Whole-cluster disaster: wipe the cluster, queue re-placement.

        The cluster's nodes go down with their pieces gone forever
        (:meth:`Cluster.declare_lost`), the cluster leaves its pool so
        binding/placement never targets it again, any ULB users bound to
        it are unbound (their next write re-assigns inside the surviving
        pool), and every chunk copy the index records on the cluster is
        queued for *cross-cluster re-placement* -- the next
        ``repair.repair()`` / scheduler repair lane rebuilds each one from
        surviving replica clusters onto a healthy cluster of the same
        pool.  Returns the number of chunk copies queued.  Idempotent.
        """
        cluster = self.clusters[cluster_id]
        tag = self._cluster_pool[cluster_id]
        remaining = tuple(i for i in self.pools[tag] if i != cluster_id)
        if not remaining and not cluster.lost:
            raise RuntimeError(
                f"cluster {cluster_id} is pool {tag!r}'s last cluster; "
                "admit_cluster() replacement capacity before declaring "
                "the loss")
        if self.cache is not None and not cluster.lost:
            self._rehome_dirty(cluster_id, remaining)
        cluster.declare_lost()
        self.pools[tag] = remaining
        for binding in self._bindings.values():
            bound = getattr(binding, "_bound", None)
            if bound:
                for user in sorted(u for u, c in bound.items()
                                   if c == cluster_id):
                    del bound[user]
        return self.repair.note_cluster_lost(cluster_id)

    def _rehome_dirty(self, cluster_id: int,
                      remaining: tuple[int, ...]) -> None:
        """Cluster loss with a dirty cache: re-plan the queued uploads.

        A dirty chunk's only bytes live in the cache -- the dying
        cluster never stored its pieces, so repair has no donors and
        re-placement would be data loss.  Instead every queued upload
        planned onto the lost cluster re-homes to a surviving cluster
        of the same pool: metadata (file entries, index record,
        reservation) moves, the task keeps its queue position, and the
        eventual drain lands the pieces on the new home.  Two-phase:
        targets are chosen for *all* tasks before anything mutates, so
        an un-re-homable loss is refused with the store intact.
        """
        doomed = [t for t in self.cache.queued_tasks()
                  if t.cluster_id == cluster_id]
        if not doomed:
            return
        extra: dict[int, int] = {}  # capacity already promised, per target
        targets: list[int] = []
        for task in doomed:
            target = None
            for cand_id in remaining:
                cand = self.clusters[cand_id]
                if (not cand.lost
                        and cand.viable(task.reserved
                                        + extra.get(cand_id, 0))):
                    target = cand_id
                    break
            if target is None:
                raise RuntimeError(
                    f"cluster {cluster_id} has {len(doomed)} queued "
                    "write-back chunk(s) and no surviving pool cluster "
                    "can take them; flush() before the loss or "
                    "admit_cluster() replacement capacity first")
            extra[target] = extra.get(target, 0) + task.reserved
            targets.append(target)
        for task, new_id in zip(doomed, targets):
            cid, old_id = task.chunk_id, task.cluster_id
            refs = self.index.get(cid, old_id).refcount
            merge = self.index.get(cid, new_id) is not None
            # rewrite live file chunk-meta-data in place (FileMeta
            # identity preserved), same recipe as repair._commit_moves
            for user in sorted(self.switching):
                table = self.switching[user].table
                for fname in sorted(table):
                    entries = table[fname].entries
                    for pos, entry in enumerate(entries):
                        if entry == (cid, old_id):
                            entries[pos] = (cid, new_id)
            if not merge:
                self.index.add(cid, new_id, len(task.data))
            self.index.add_ref(cid, new_id, count=refs)
            self.index.release(cid, old_id, count=refs)
            self.clusters[old_id].release_reservation(task.reserved)
            if merge:
                # the target already holds live pieces of this exact
                # content -- the queued upload is now redundant
                self.cache.drop_task(task)
            else:
                self.clusters[new_id].reserve(task.reserved)
                self.cache.rehome_dirty(task, new_id)

    def admit_cluster(self, storage_class: str | None = None,
                      node_capacity: int | None = None) -> Cluster:
        """Bring a fresh cluster online in a class's pool.

        The new cluster gets the next free cluster id and the pool's own
        ``(n, k)`` (via :meth:`StorageClass.spawn_cluster`); binding and
        placement see it immediately.  The admission half of the
        ``declare_cluster_lost`` lifecycle -- replacement capacity after
        a disaster, or elastic growth for a hot pool.
        """
        cls = self._class(storage_class)
        cluster = cls.spawn_cluster(
            len(self.clusters),
            self._node_capacity if node_capacity is None else node_capacity)
        self.clusters.append(cluster)
        self.pools[cls.pool_tag] += (cluster.cluster_id,)
        self._cluster_pool[cluster.cluster_id] = cls.pool_tag
        return cluster

    # ------------------------------------------------------------------
    REPAIR_BATCH = 256  # chunks decoded+re-encoded per repair sub-batch

    def repair_cluster(self, cluster_id: int) -> int:
        """Re-create missing pieces on revived/replacement nodes.

        Thin single-cluster wrapper over :class:`RepairManager`: scans the
        cluster, skips whole chunks, rebuilds the rest most-at-risk first
        in cross-cluster engine sub-batches, and records unrecoverable
        chunks in the report instead of aborting the pass.  Returns the
        number of pieces rebuilt; use ``repair_all`` (or
        ``store.repair.repair(...)`` directly) for the full
        :class:`RepairReport`.
        """
        return self.repair.repair(cluster_ids=[cluster_id]).pieces_rebuilt

    def repair_all(self) -> RepairReport:
        """Storm recovery: prioritized repair pass over every cluster.

        Each chunk rebuilds with its *owning cluster's* ``(n, k)``, so a
        mixed-class storm heals every pool with the right code.
        """
        return self.repair.repair()

    # ------------------------------------------------------------------
    def stats(self) -> StoreStats:
        piece_bytes = sum(c.used for c in self.clusters)
        index_bytes = self.index.index_bytes + sum(
            sw.meta_bytes for sw in self.switching.values())
        # per-class slices: pool-level byte/chunk counts + exact
        # per-class logical bytes, file counts and meta bytes
        meta_by_class: dict[str, int] = {name: 0 for name in self.classes}
        for sw in self.switching.values():
            for meta in sw.table.values():
                if meta.storage_class in meta_by_class:
                    meta_by_class[meta.storage_class] += meta.meta_bytes
        per_class: dict[str, ClassStats] = {}
        for name, cls in self.classes.items():
            pool_ids = self.pools[cls.pool_tag]
            pool_chunks = sum(len(self.index.cluster_chunks(i))
                              for i in pool_ids)
            per_class[name] = ClassStats(
                name=name, n=cls.n, k=cls.k, n_clusters=len(pool_ids),
                logical_bytes=self._logical[name],
                piece_bytes=sum(self.clusters[i].used for i in pool_ids),
                index_bytes=(dedup.CHUNK_RECORD_BYTES * pool_chunks
                             + meta_by_class[name]),
                n_files=self._nfiles[name],
                n_unique_chunks=pool_chunks)
        return StoreStats(logical_bytes=self.logical_bytes,
                          piece_bytes=piece_bytes,
                          index_bytes=index_bytes,
                          n_unique_chunks=len(self.index),
                          n_files=self.n_files,
                          per_class=per_class,
                          cache=(dataclasses.replace(self.cache.stats)
                                 if self.cache is not None else None))
