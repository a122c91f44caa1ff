"""Failure-storm repair: prioritized cross-cluster rebuild (paper S II, IV).

SEARS's reliability rests on erasure-coded clusters being rebuilt before a
second failure strikes.  After a failure storm many clusters are degraded
at once, and the chunks at greatest risk are the ones with the fewest
surviving pieces -- those must be rebuilt first, while fully healthy
chunks must not cost any data-plane work at all.

``RepairManager`` owns that process:

* **scan** -- a bulk :meth:`Cluster.piece_census` per cluster classifies
  every chunk copy: *whole* (skipped), *degraded* (queued, priority =
  fewest surviving pieces first), or *unrecoverable right now* (< k
  surviving pieces; recorded, re-queued in case a later revive helps).
* **queue** -- a persistent priority queue shared by full scans and
  *read-repair hints*: a degraded ``get`` (non-systematic piece set)
  enqueues the chunk it touched, so hot data heals without waiting for
  the next full scan.
* **drain** -- the queue drains as *cross-cluster sub-batches*: up to
  ``sub_batch`` chunks spanning any number of clusters are re-censused,
  bulk-read, then pushed through the ``CodingEngine`` seam as **one**
  decode batch plus **one** encode batch per distinct cluster code
  (``engine.recode_blobs_multi``), so a sub-batch costs O(code buckets x
  length buckets) kernel launches, never O(chunks).  Every chunk rebuilds
  with its *owning cluster's* ``(n, k)`` -- under storage classes the
  store has no single global code.
  Per-chunk failures land in the :class:`RepairReport` instead of
  aborting the pass -- a storm survivor always gets a full accounting of
  what was rebuilt, what was already whole, and what is (still) lost.

On a sharded store (``SEARSStore(shards=N)``) repair is *head-
coordinated, shard-routed*: the queue, censuses and recode batches stay
one cross-cluster lane (repair batches by cluster code, not by user, so
per-shard demux would only fragment the launch buckets), but every
metadata mutation a repair plan commits — index records, refcount
moves, ``FileMeta`` entry rewrites — routes through the owning control
shard via the store's ``ShardedChunkIndex``/``ShardedSwitchTable``
facades, and the sanitizer's per-shard ledger check verifies each
drain left every shard balanced.

Disaster recovery extends the same machinery across clusters:

* **cross-cluster re-placement** -- a chunk below ``k`` survivors on its
  home cluster (or whose home was ``declare_lost()``) is rebuilt from the
  piece *union* of the home's survivors and any surviving replica
  clusters carrying the same ``(n, k)`` (RS pieces are
  content-deterministic, so piece indices are interchangeable across
  copies), and lands on a healthy cluster of the same pool -- through the
  same ``recode_blobs_multi`` sub-batch seam, so re-placement stays
  O(code buckets x length buckets) launches.  Binding, ``FileMeta``
  entries, and the index refcounts move atomically per chunk; when a
  healthy replica copy already exists and no fresh target is viable, the
  move is metadata-only (a *merge*: zero launches, zero writes).
* **proactive scrubbing** -- :meth:`RepairManager.scrub` runs sampled
  ``piece_census`` sweeps under per-class budgets with persistent
  per-cluster cursors, feeding the queue before reads discover damage
  (the ``BatchScheduler`` drives it from a timer lane).
* **repair throttling** -- with a
  :class:`repro_torch.core.latency.RepairBandwidth` installed, :meth:`drain`
  draws each chunk's estimated traffic from the token bucket and defers
  what the budget refuses (``RepairReport.deferred``); the bytes it does
  move feed the per-cluster utilisation foreground retrievals are
  charged.

``SEARSStore.repair_cluster`` is a thin single-cluster wrapper;
``BatchScheduler`` drains the queue as a bounded background lane between
user flush windows so repair traffic never starves foreground puts/gets.
"""

from __future__ import annotations

import dataclasses
import heapq


@dataclasses.dataclass(frozen=True)
class RepairItem:
    """One queued chunk copy, with the survivorship seen at enqueue time.

    The priority snapshot may go stale while the item waits (more
    failures, revives, deletes); the drain step re-censuses every
    sub-batch, so staleness only ever affects *ordering*, never safety.
    """

    chunk_id: bytes
    cluster_id: int
    length: int  # original chunk bytes (decode target)
    n_survivors: int  # alive piece holders at enqueue time

    @property
    def key(self) -> tuple[bytes, int]:
        return (self.chunk_id, self.cluster_id)

    @property
    def priority(self) -> tuple[int, int, bytes]:
        """Fewest surviving pieces first; deterministic tie-break."""
        return (self.n_survivors, self.cluster_id, self.chunk_id)


@dataclasses.dataclass
class RepairReport:
    """Per-chunk outcome accounting for one repair pass.

    Chunk copies are identified as (chunk_id, cluster_id) and land in
    exactly one bucket: ``rebuilt`` (>= 1 piece landed; partial write
    misses stay visible in ``errors``), ``skipped_healthy``,
    ``unrecoverable`` (< k survivors *cluster-wide*: the home survivors
    plus every donor copy's still leave fewer than k distinct pieces),
    ``failed`` (decodable but every rebuild write failed -- still
    degraded, retried by a later scan or hint), ``replaced`` (the copy
    moved to another cluster: fresh re-placement or metadata-only merge),
    or ``replace_failed`` (a move was attempted but could not commit --
    the home record survives, retried later).  Two piece-conservation
    identities make up ``balanced``:

    * in-place lane: ``pieces_missing == pieces_rebuilt + pieces_failed
      + pieces_unrecoverable`` -- every missing alive-node piece of a
      chunk that *stays home* is accounted for;
    * re-placement lane: ``pieces_replace_targets == pieces_replaced +
      pieces_replace_failed`` -- every piece slot targeted on a new home
      is accounted for.  Re-placed copies never touch ``pieces_missing``
      (their home slots are abandoned with the move, not rebuilt).
    """

    rebuilt: list[tuple[bytes, int]] = dataclasses.field(default_factory=list)
    skipped_healthy: list[tuple[bytes, int]] = dataclasses.field(
        default_factory=list)
    unrecoverable: list[tuple[bytes, int]] = dataclasses.field(
        default_factory=list)
    failed: list[tuple[bytes, int]] = dataclasses.field(
        default_factory=list)  # decodable but every rebuild write failed
    replaced: list[tuple[bytes, int, int]] = dataclasses.field(
        default_factory=list)  # (chunk, old_cluster, new_cluster) moves
    replace_failed: list[tuple[bytes, int]] = dataclasses.field(
        default_factory=list)  # decodable but the move could not commit
    errors: list[tuple[bytes, int, str]] = dataclasses.field(
        default_factory=list)  # per-piece write failures (chunk, cluster, err)
    pieces_rebuilt: int = 0
    pieces_missing: int = 0  # missing alive-node pieces seen by the pass
    pieces_failed: int = 0  # rebuild computed but the write failed
    pieces_unrecoverable: int = 0  # missing pieces of < k-survivor chunks
    pieces_replaced: int = 0  # pieces landed on a re-placement target
    pieces_replace_targets: int = 0  # piece slots attempted on new homes
    pieces_replace_failed: int = 0  # re-placement writes that failed
    deferred: int = 0  # queued chunks pushed back by the bandwidth budget
    n_scanned: int = 0  # chunk copies censused by scans feeding this pass
    n_sub_batches: int = 0  # engine recode batches issued

    @property
    def n_chunks(self) -> int:
        """Chunk copies this pass classified (drain outcomes + scan skips)."""
        return (len(self.rebuilt) + len(self.skipped_healthy)
                + len(self.unrecoverable) + len(self.failed)
                + len(self.replaced) + len(self.replace_failed))

    @property
    def balanced(self) -> bool:
        """Do both piece ledgers account for every piece they saw?"""
        return (self.pieces_missing == (self.pieces_rebuilt
                                        + self.pieces_failed
                                        + self.pieces_unrecoverable)
                and self.pieces_replace_targets == (
                    self.pieces_replaced + self.pieces_replace_failed))

    def merge(self, other: "RepairReport") -> "RepairReport":
        self.rebuilt += other.rebuilt
        self.skipped_healthy += other.skipped_healthy
        self.unrecoverable += other.unrecoverable
        self.failed += other.failed
        self.replaced += other.replaced
        self.replace_failed += other.replace_failed
        self.errors += other.errors
        self.pieces_rebuilt += other.pieces_rebuilt
        self.pieces_missing += other.pieces_missing
        self.pieces_failed += other.pieces_failed
        self.pieces_unrecoverable += other.pieces_unrecoverable
        self.pieces_replaced += other.pieces_replaced
        self.pieces_replace_targets += other.pieces_replace_targets
        self.pieces_replace_failed += other.pieces_replace_failed
        self.deferred += other.deferred
        self.n_scanned += other.n_scanned
        self.n_sub_batches += other.n_sub_batches
        return self


@dataclasses.dataclass
class ScrubReport:
    """Outcome of one proactive scrub sweep (no data-plane work).

    ``n_censused`` chunk copies were health-checked this sweep;
    ``n_enqueued`` of them were newly queued for repair.  ``per_pool``
    breaks the census count down by cluster-pool tag (classes sharing a
    pool share its sweep).
    """

    n_censused: int = 0
    n_enqueued: int = 0
    per_pool: dict[str, int] = dataclasses.field(default_factory=dict)


class RepairManager:
    """Prioritized cross-cluster rebuild through the batched data plane.

    Holds a persistent repair queue fed by full scans
    (:meth:`scan`) and read-repair hints (:meth:`hint`), drained in
    most-at-risk-first order as length-bucketed engine sub-batches
    (:meth:`drain`).  :meth:`repair` is the scan-then-drain full pass.
    """

    SUB_BATCH = 256  # chunks recoded per engine sub-batch window
    SCRUB_BUDGET = 64  # chunk copies censused per class per scrub sweep

    def __init__(self, store, sub_batch: int | None = None,
                 bandwidth=None) -> None:
        self.store = store
        self.sub_batch = sub_batch or self.SUB_BATCH
        self.bandwidth = bandwidth  # latency.RepairBandwidth | None
        self._pending: dict[tuple[bytes, int], RepairItem] = {}
        self._scrub_cursor: dict[int, int] = {}  # cluster -> sweep position

    # ------------------------------------------------------------ queue ---
    @property
    def pending(self) -> int:
        """Chunk copies currently queued for repair."""
        return len(self._pending)

    def _is_dirty(self, chunk_id: bytes, cluster_id: int) -> bool:
        """True for a write-back chunk copy whose pieces have not landed.

        Dirty copies are invisible to every repair lane: their index
        record deliberately has no pieces yet (the cache drain will land
        them), so a census would misread them as total damage and
        re-placement would destroy the only copy's metadata.
        """
        cache = getattr(self.store, "cache", None)
        return cache is not None and cache.is_dirty(chunk_id, cluster_id)

    def hint(self, chunk_id: bytes, cluster_id: int) -> bool:
        """Read-repair hint: a degraded read touched this chunk copy.

        Censuses just that chunk and enqueues it when pieces are missing
        on alive nodes (or fewer than k survive -- so the next pass
        *reports* the loss).  A hint for a whole chunk -- e.g. a read that
        went non-systematic only because a holder node is down -- is
        dropped.  Returns True when the chunk was queued.
        """
        key = (chunk_id, cluster_id)
        if key in self._pending:
            return True
        info = self.store.index.get(chunk_id, cluster_id)
        if info is None:
            return False  # deleted since the read was planned
        if self._is_dirty(chunk_id, cluster_id):
            return False  # pieces land at write-back drain, not here
        cluster = self.store.clusters[cluster_id]
        health = cluster.piece_census([chunk_id])[chunk_id]
        if health.whole and health.recoverable(cluster.k):
            return False
        self._pending[key] = RepairItem(
            chunk_id=chunk_id, cluster_id=cluster_id, length=info.length,
            n_survivors=len(health.holders))
        return True

    def note_cluster_lost(self, cluster_id: int) -> int:
        """Queue every chunk copy of a declared-lost cluster at top priority.

        Called by ``SEARSStore.declare_cluster_lost``; no census is taken
        (the cluster has zero survivors by definition -- ``n_survivors=0``
        puts the whole batch at the head of the queue).  The drain step
        re-censuses and routes each chunk through cross-cluster
        re-placement.  Returns the number of chunk copies queued.
        """
        queued = 0
        index = self.store.index
        for cid in sorted(index.cluster_chunks(cluster_id)):
            info = index.get(cid, cluster_id)
            self._pending[(cid, cluster_id)] = RepairItem(
                chunk_id=cid, cluster_id=cluster_id, length=info.length,
                n_survivors=0)
            queued += 1
        return queued

    def cluster_rho(self, cluster_id: int) -> float:
        """Repair-traffic utilisation foreground reads are charged."""
        if self.bandwidth is None:
            return 0.0
        return self.bandwidth.rho(cluster_id)

    def scan(self, cluster_ids: list[int] | None = None) -> RepairReport:
        """Census every chunk copy of the given (default: all) clusters.

        Whole chunks land in the returned report's ``skipped_healthy``
        without touching the queue; degraded and currently-unrecoverable
        chunks are (re-)queued with fresh priorities.  No data-plane work
        happens here -- the scan is pure metadata plus per-node health
        bitmaps.
        """
        report = RepairReport()
        if cluster_ids is None:
            cluster_ids = [c.cluster_id for c in self.store.clusters]
        for cluster_id in cluster_ids:
            cids = [cid for cid
                    in sorted(self.store.index.cluster_chunks(cluster_id))
                    if not self._is_dirty(cid, cluster_id)]
            if not cids:
                continue
            cluster = self.store.clusters[cluster_id]
            census = cluster.piece_census(cids)
            report.n_scanned += len(cids)
            for cid in cids:
                health = census[cid]
                if health.whole and health.recoverable(cluster.k):
                    # drop any stale queue entry (e.g. a read-repair hint
                    # whose empty replacement died again) so the copy is
                    # reported in exactly one bucket, not re-drained
                    self._pending.pop((cid, cluster_id), None)
                    report.skipped_healthy.append((cid, cluster_id))
                    continue
                info = self.store.index.get(cid, cluster_id)
                self._pending[(cid, cluster_id)] = RepairItem(
                    chunk_id=cid, cluster_id=cluster_id, length=info.length,
                    n_survivors=len(health.holders))
        return report

    # ------------------------------------------------------------ drain ---
    def drain(self, max_chunks: int | None = None,
              cluster_ids: list[int] | None = None) -> RepairReport:
        """Rebuild up to ``max_chunks`` queued chunks, most at risk first.

        ``cluster_ids`` restricts the drain to items of those clusters
        (the single-cluster ``repair_cluster`` contract); the default
        drains the whole queue.  The selected items are sliced into
        cross-cluster sub-batches of at most ``sub_batch`` chunks; each
        sub-batch is re-censused (the queue snapshot may be stale),
        bulk-read per cluster, then recoded through the engine as one
        decode + one encode batch.  Chunks that turn out whole are
        skipped; chunks below k survivors are recorded unrecoverable (and
        dropped from the queue -- a later revive must re-hint or re-scan
        them); per-piece write failures are recorded without aborting the
        pass.

        With a throttling :class:`~repro_torch.core.latency.RepairBandwidth`
        installed, each selected chunk first draws ~2x its length (read
        the survivors + write the rebuilt pieces) from the token bucket;
        on the first refusal the rest of the selection is *deferred* --
        left queued, counted in ``report.deferred`` -- so a rebuild storm
        trickles out at the budget rate in strict priority order.
        """
        pool = list(self._pending.values())
        if cluster_ids is not None:
            scope = set(cluster_ids)
            pool = [it for it in pool if it.cluster_id in scope]
        if max_chunks is not None and max_chunks < len(pool):
            # bounded lane: pick the top of the queue without paying a
            # full O(P log P) sort per flush on a storm-sized backlog
            items = heapq.nsmallest(max_chunks, pool,
                                    key=lambda it: it.priority)
        else:
            items = sorted(pool, key=lambda it: it.priority)
        report = RepairReport()
        bw = self.bandwidth
        if bw is not None and bw.limit_bps is not None:
            admitted: list[RepairItem] = []
            for i, it in enumerate(items):
                if not bw.try_take(2 * it.length):
                    # budget exhausted: everything behind this item is
                    # lower priority -- defer it all (items stay queued)
                    report.deferred += len(items) - i
                    break
                admitted.append(it)
            items = admitted
        for start in range(0, len(items), self.sub_batch):
            self._repair_sub_batch(items[start:start + self.sub_batch],
                                   report)
        san = getattr(self.store, "_sanitizer", None)
        if san is not None:
            san.check_window("repair drain")
        return report

    def repair(self, cluster_ids: list[int] | None = None,
               max_chunks: int | None = None) -> RepairReport:
        """Scan the given clusters, then drain their queued chunks.

        With ``cluster_ids=None`` this is the storm-recovery full pass:
        the drain also covers previously queued hints/items, so one
        ``repair()`` call settles every known degraded chunk copy
        system-wide.  With explicit clusters the pass stays scoped --
        other clusters' queued hints are left for their own pass (or the
        scheduler's background lane).
        """
        report = self.scan(cluster_ids)
        return report.merge(self.drain(max_chunks=max_chunks,
                                       cluster_ids=cluster_ids))

    # ------------------------------------------------------------ scrub ---
    def scrub(self, budget: int | dict[str, int] | None = None
              ) -> ScrubReport:
        """Proactive sampled census sweep feeding the repair queue.

        Walks every cluster pool with a persistent per-cluster cursor, so
        consecutive sweeps cover different slices and eventually the whole
        population -- damage is found *before* a degraded read trips over
        it.  Each sweep censuses up to the pool's budget of chunk copies
        (``SCRUB_BUDGET`` per storage class by default; classes sharing a
        pool tag pool their budgets; pass an int to override every class,
        or a ``{class_name: budget}`` dict for per-class control).
        Damaged or at-risk copies are (re-)queued exactly like
        :meth:`scan`; healthy copies drop any stale queue entry.  Pure
        metadata plus per-node health bitmaps -- zero data-plane launches
        -- so the scheduler can run it from a timer lane without
        perturbing foreground windows.
        """
        store = self.store
        report = ScrubReport()
        budgets: dict[str, int] = {}
        for name in sorted(store.classes):
            cls = store.classes[name]
            if isinstance(budget, dict):
                b = budget.get(cls.name, self.SCRUB_BUDGET)
            else:
                b = self.SCRUB_BUDGET if budget is None else budget
            budgets[cls.pool_tag] = budgets.get(cls.pool_tag, 0) + b
        for tag in sorted(budgets):
            cids_of = {}  # populated clusters of the pool, in pool order
            for cluster_id in store.pools.get(tag, ()):
                cids = sorted(store.index.cluster_chunks(cluster_id))
                if cids:
                    cids_of[cluster_id] = cids
            remaining = budgets[tag]
            swept = 0
            left = len(cids_of)
            for cluster_id, cids in cids_of.items():
                share = -(-remaining // left) if left else 0  # ceil split
                left -= 1
                if share <= 0:
                    continue
                cluster = store.clusters[cluster_id]
                cursor = self._scrub_cursor.get(cluster_id, 0) % len(cids)
                take = min(share, len(cids))
                window = [cids[(cursor + j) % len(cids)]
                          for j in range(take)]
                self._scrub_cursor[cluster_id] = (cursor + take) % len(cids)
                remaining -= take
                swept += take
                census = cluster.piece_census(window)
                for cid in window:
                    if self._is_dirty(cid, cluster_id):
                        continue  # pieces pending at the write-back drain
                    health = census[cid]
                    if health.whole and health.recoverable(cluster.k):
                        self._pending.pop((cid, cluster_id), None)
                        continue
                    info = store.index.get(cid, cluster_id)
                    if info is None:
                        continue
                    if (cid, cluster_id) not in self._pending:
                        report.n_enqueued += 1
                    self._pending[(cid, cluster_id)] = RepairItem(
                        chunk_id=cid, cluster_id=cluster_id,
                        length=info.length,
                        n_survivors=len(health.holders))
            report.n_censused += swept
            if swept:
                report.per_pool[tag] = swept
        return report

    # ----------------------------------------------------------- helpers --
    def _note_traffic(self, cluster_id: int, nbytes: int) -> None:
        """Feed actual repair bytes into the bandwidth load model."""
        if self.bandwidth is not None and nbytes:
            self.bandwidth.note(cluster_id, nbytes)

    def _repair_sub_batch(self, items: list[RepairItem],
                          report: RepairReport) -> None:
        """One cross-cluster sub-batch: census, classify, read, recode, write.

        Two lanes share the single engine call:

        * **in-place** -- the home cluster still has >= k survivors:
          rebuild its alive-missing slots exactly as before;
        * **re-placement** -- the home is lost or below k survivors: if
          the cross-cluster piece union (home survivors + every same-code
          donor copy) reaches k, decode from the union and land the full
          piece set on a viable non-holder cluster of the same pool
          (falling back to a metadata-only merge onto a healthy donor
          copy), then move the index record, refcounts and every file
          chunk-meta-data entry atomically; otherwise the chunk is
          honestly unrecoverable.

        Both lanes' decodes and encodes ride ONE
        ``engine.recode_blobs_multi`` call, so the sub-batch stays
        O(code buckets x length buckets) launches, never O(chunks).
        """
        store = self.store
        by_cluster: dict[int, list[RepairItem]] = {}
        for it in items:
            self._pending.pop(it.key, None)
            by_cluster.setdefault(it.cluster_id, []).append(it)

        # fresh census + classification (the queued priority may be stale;
        # recoverability is judged by each cluster's *own* k)
        live: list[RepairItem] = []
        targets: dict[tuple[bytes, int], tuple[int, ...]] = {}
        moves: list[RepairItem] = []  # homes that cannot decode alone
        health_of: dict[tuple[bytes, int], object] = {}
        for cluster_id, its in sorted(by_cluster.items()):
            cluster = store.clusters[cluster_id]
            census = cluster.piece_census([it.chunk_id for it in its])
            for it in its:
                if store.index.get(it.chunk_id, cluster_id) is None:
                    continue  # deleted while queued: nothing to account
                if self._is_dirty(it.chunk_id, cluster_id):
                    continue  # write-back pending: drain owns the pieces
                health = census[it.chunk_id]
                if cluster.lost or not health.recoverable(cluster.k):
                    # the home alone cannot decode (covers a declared-lost
                    # cluster and a "whole" chunk whose only alive nodes
                    # are its too-few holders) -- try the cross-cluster
                    # piece union in the re-placement lane
                    moves.append(it)
                    health_of[it.key] = health
                elif health.whole:
                    report.skipped_healthy.append(it.key)
                else:
                    report.pieces_missing += len(health.missing)
                    live.append(it)
                    targets[it.key] = health.missing

        # --- re-placement lane: donor discovery + target selection -------
        # donors = other clusters with an indexed copy under the same
        # (n, k); RS pieces are content-deterministic, so their piece
        # indices union with the home's survivors
        donor_cids: dict[int, list[bytes]] = {}
        for it in moves:
            home = store.clusters[it.cluster_id]
            for dcl in store.index.copies(it.chunk_id):
                if dcl == it.cluster_id:
                    continue
                donor = store.clusters[dcl]
                if donor.lost or (donor.n, donor.k) != (home.n, home.k):
                    continue
                donor_cids.setdefault(dcl, []).append(it.chunk_id)
        donor_census: dict[int, dict] = {}
        for dcl in sorted(donor_cids):
            donor_census[dcl] = store.clusters[dcl].piece_census(
                sorted(set(donor_cids[dcl])))

        fresh: list[tuple[RepairItem, int]] = []  # (item, target cluster)
        merges: list[tuple[RepairItem, int]] = []
        for it in moves:
            home = store.clusters[it.cluster_id]
            health = health_of[it.key]
            donors = [dcl for dcl in store.index.copies(it.chunk_id)
                      if dcl != it.cluster_id and dcl in donor_census]
            avail = set(health.holders)
            for dcl in donors:
                avail |= set(donor_census[dcl][it.chunk_id].holders)
            if len(avail) < home.k:
                # fewer than k distinct pieces survive *anywhere*: honest
                # accounting, same ledger as the old single-cluster path
                report.pieces_missing += len(health.missing)
                report.unrecoverable.append(it.key)
                report.pieces_unrecoverable += len(health.missing)
                continue
            # fresh placement first (restores full n-piece redundancy);
            # target = most-free viable non-holder cluster of the pool
            pool_ids = store.pools.get(store.pool_of(it.cluster_id), ())
            holders_of_copy = set(store.index.copies(it.chunk_id))
            need = home.n * home.code.piece_len(it.length)
            cands = [store.clusters[i] for i in pool_ids
                     if i != it.cluster_id and i not in holders_of_copy
                     and store.clusters[i].viable(need)]
            if cands:
                target = max(cands, key=lambda c: (c.free, -c.cluster_id))
                fresh.append((it, target.cluster_id))
                continue
            # merge fallback: fold the refs onto a healthy existing donor
            # copy -- metadata only, zero launches, zero bytes moved
            mergeable = [dcl for dcl in donors
                         if len(donor_census[dcl][it.chunk_id].holders)
                         >= store.clusters[dcl].k]
            if mergeable:
                best = max(mergeable, key=lambda d: (
                    len(donor_census[d][it.chunk_id].holders), -d))
                merges.append((it, best))
            else:
                # decodable, but no viable new home right now: keep the
                # old record, retry on a later pass (zero piece targets,
                # so the replace ledger stays balanced)
                report.replace_failed.append(it.key)

        # --- bulk piece reads ------------------------------------------
        # in-place items read k survivors from home; re-placement items
        # collect k distinct piece indices across home + donors -- one
        # bulk read per source cluster either way
        pieces: dict[tuple[bytes, int], dict[int, bytes]] = {}
        for cluster_id, its in sorted(by_cluster.items()):
            want = [it.chunk_id for it in its if it.key in targets]
            if want:
                cluster = store.clusters[cluster_id]
                got = cluster.read_pieces_batch(want, cluster.k)
                nbytes = 0
                for cid in want:
                    pieces[(cid, cluster_id)] = got[cid]
                    nbytes += sum(len(p) for p in got[cid].values())
                self._note_traffic(cluster_id, nbytes)

        union: dict[tuple[bytes, int], dict[int, bytes]] = {
            it.key: {} for it, _t in fresh}
        src_items: dict[int, list[RepairItem]] = {}
        for it, _t in fresh:
            home = store.clusters[it.cluster_id]
            srcs = [] if home.lost else [it.cluster_id]
            srcs += [dcl for dcl in store.index.copies(it.chunk_id)
                     if dcl != it.cluster_id and dcl in donor_census]
            for dcl in srcs:
                src_items.setdefault(dcl, []).append(it)
        for dcl in sorted(src_items):
            wanting = [it for it in src_items[dcl]
                       if len(union[it.key]) < store.clusters[it.cluster_id].k]
            if not wanting:
                continue
            cluster = store.clusters[dcl]
            got = cluster.read_pieces_batch(
                [it.chunk_id for it in wanting], cluster.k)
            nbytes = 0
            for it in wanting:
                k = store.clusters[it.cluster_id].k
                for idx in sorted(got[it.chunk_id]):
                    if len(union[it.key]) >= k:
                        break
                    if idx not in union[it.key]:
                        union[it.key][idx] = got[it.chunk_id][idx]
                        nbytes += len(got[it.chunk_id][idx])
            self._note_traffic(dcl, nbytes)
        # a donor may have decayed between census and read: anything
        # short of k pieces cannot decode after all -- push it back
        short = [(it, t) for it, t in fresh
                 if len(union[it.key]) < store.clusters[it.cluster_id].k]
        for it, _t in short:
            report.replace_failed.append(it.key)
        fresh = [(it, t) for it, t in fresh
                 if len(union[it.key]) >= store.clusters[it.cluster_id].k]

        # --- ONE decode + ONE encode batch per distinct cluster code ----
        # for the whole cross-cluster sub-batch, both lanes together --
        # each chunk recodes with its owning cluster's (n, k), never a
        # store-wide global
        jobs = ([(store.clusters[it.cluster_id].code, pieces[it.key],
                  it.length) for it in live]
                + [(store.clusters[it.cluster_id].code, union[it.key],
                    it.length) for it, _t in fresh])
        all_pieces: list = []
        if jobs:
            san = getattr(store, "_sanitizer", None)
            if san is not None:
                # recode = decode + re-encode: two GF launches per chunk
                # is the ceiling, (code, length)-bucketing merges below
                san.add_repair_budget(len(jobs))
                _, all_pieces = san.track(store.engine.recode_blobs_multi,
                                          jobs)
            else:
                _, all_pieces = store.engine.recode_blobs_multi(jobs)
            report.n_sub_batches += 1

        # --- in-place writes -------------------------------------------
        for it, chunk_pieces in zip(live, all_pieces[:len(live)]):
            cluster = store.clusters[it.cluster_id]
            wrote = failures = nbytes = 0
            for node_id in targets[it.key]:
                node = cluster.nodes[node_id]
                if not node.alive or node.has(it.chunk_id, node_id):
                    # state moved under us (node died / piece appeared):
                    # the slot is no longer an alive-missing piece
                    report.pieces_missing -= 1
                    continue
                try:
                    node.put(it.chunk_id, node_id, chunk_pieces[node_id])
                    wrote += 1
                    nbytes += len(chunk_pieces[node_id])
                except Exception as exc:  # capacity, node death, conflict
                    report.errors.append((it.chunk_id, it.cluster_id,
                                          str(exc)))
                    report.pieces_failed += 1
                    failures += 1
            self._note_traffic(it.cluster_id, nbytes)
            report.pieces_rebuilt += wrote
            if wrote:
                report.rebuilt.append(it.key)  # errors hold partial misses
            elif failures:
                # decodable, but no piece landed: the chunk is still
                # degraded -- report it as failed, never as healthy (a
                # later scan or hint retries it)
                report.failed.append(it.key)
            else:
                # every target healed (or vanished) between census and
                # write -- the chunk is whole, not rebuilt by us
                report.skipped_healthy.append(it.key)

        # --- re-placement writes + atomic metadata moves ---------------
        committed: list[tuple[RepairItem, int]] = []
        for (it, target_id), chunk_pieces in zip(fresh,
                                                 all_pieces[len(live):]):
            target = store.clusters[target_id]
            wrote = failures = nbytes = 0
            written: list[int] = []  # piece slots *we* created (rollback)
            for node in target.nodes:
                if not node.alive:
                    continue
                report.pieces_replace_targets += 1
                already = node.has(it.chunk_id, node.node_id)
                try:
                    node.put(it.chunk_id, node.node_id,
                             chunk_pieces[node.node_id])
                    wrote += 1
                    if not already:
                        written.append(node.node_id)
                        nbytes += len(chunk_pieces[node.node_id])
                except Exception as exc:  # capacity, conflict
                    report.errors.append((it.chunk_id, target_id,
                                          str(exc)))
                    failures += 1
            self._note_traffic(target_id, nbytes)
            if wrote >= target.k:
                report.pieces_replaced += wrote
                report.pieces_replace_failed += failures
                committed.append((it, target_id))
            else:
                # the new copy would be born unrecoverable: roll back the
                # slots we created (never pre-existing identical pieces
                # from an earlier move of the same content) and retry on
                # a later pass
                for node_id in written:
                    target.nodes[node_id].delete(it.chunk_id, node_id)
                report.pieces_replace_failed += wrote + failures
                report.replace_failed.append(it.key)
        self._commit_moves(committed + merges, report)

    def _commit_moves(self, moves: list[tuple[RepairItem, int]],
                      report: RepairReport) -> None:
        """Atomically move chunk-copy metadata to the new home clusters.

        For every (item, new_cluster): rewrite each live file
        chunk-meta-data entry in place (``FileMeta`` identity is
        preserved -- rollback machinery may hold references), move the
        refcounts (defensive ``add`` -- an idempotent double-placement of
        the same content already created the record), release the old
        record, and drop any leftover home pieces so no orphan survives.
        """
        store = self.store
        if not moves:
            return
        remap = {(it.chunk_id, it.cluster_id): new_id
                 for it, new_id in moves}
        for user in sorted(store.switching):
            table = store.switching[user].table
            for fname in sorted(table):
                entries = table[fname].entries
                for pos, entry in enumerate(entries):
                    new_id = remap.get(entry)
                    if new_id is not None:
                        entries[pos] = (entry[0], new_id)
        for it, new_id in moves:
            cid, old_id = it.chunk_id, it.cluster_id
            refs = store.index.get(cid, old_id).refcount
            if store.index.get(cid, new_id) is None:
                store.index.add(cid, new_id, it.length)
            store.index.add_ref(cid, new_id, count=refs)
            store.index.release(cid, old_id, count=refs)
            store.clusters[old_id].delete_chunk(cid)
            report.replaced.append((cid, old_id, new_id))
