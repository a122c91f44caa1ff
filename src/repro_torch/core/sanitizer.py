"""Runtime sanitizer for the batched data plane (``SEARSStore(...,
sanitize=True)`` / ``SEARS_SANITIZE=1``).

Three checks, mirroring the searslint static passes at runtime:

1. **Begin purity** — every ``*_begin`` seam runs under
   :meth:`Sanitizer.guard_begin`, which hashes the store's control-plane
   state (dedup index, switching tables, cluster/node occupancy,
   binding state, repair queue) before and after the call and raises
   :class:`SanitizerError` on any difference.  This is the runtime twin
   of the PR 6 byte-identity proof: a begin that mutates state breaks
   pipelined/sequential equivalence.

2. **Expected-launch model** — window hooks accumulate a per-family
   launch *budget* (gear: one per distinct chunker per put window;
   sha1: ``ceil(chunks / hash_batch)``; gf/fused: one per ``(code,
   TILE_L-quantized piece length)`` bucket; repair: decode + encode per
   recoded chunk whether it rebuilds in place or re-places onto another
   cluster; scrub sweeps and metadata-only merges: zero) and
   :meth:`check_launches` asserts the launches
   attributed to this store never exceed it.  Budgets and attributed
   counts are cumulative over the store's lifetime, so pipelined window
   interleaving (begin i+1 before finish i) needs no special casing.  The model is an
   upper bound: an engine may merge buckets or skip host-path work,
   never dispatch more.

3. **Piece-ledger conservation** — after every put window and repair
   drain: each ``(chunk, cluster)`` index record's refcount equals the
   number of live files referencing it (once per file), and every piece
   held by any node belongs to a live index record under that piece's
   slot.  Cross-cluster re-placement must therefore move record,
   refcounts, file entries and pieces as one step — a half-moved chunk
   (stale entries, leftover home pieces) trips this check at the next
   window boundary.  On a sharded store the ledger is also checked
   *per control shard*: every chunk record / switching table / binding
   entry must live on its bucket owner and each shard's refcounts must
   balance the live references to its own chunks, so a half-migrated
   bucket or a write routed past the owner cannot hide in global sums.

``LAUNCHES`` is process-global, so the sanitizer *attributes* launches
to its own store by bracketing every store code path that dispatches
device work (:meth:`tracking`); only deltas observed inside those
brackets count against the budget.  Several sanitized stores can
therefore interleave in one process (the differential tests do exactly
that) — each sees only its own traffic.  :meth:`resync` zeroes the
attributed count and budget if a harness wants a fresh ledger.
Fingerprinting walks private control-plane structures on purpose — the
sanitizer is a diagnostics layer and must see exactly the state the
invariants quantify over.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Callable

from repro_torch.kernels.launches import LAUNCHES, LaunchCounter

_FAMILIES = ("gf", "sha1", "gear", "fused")


class SanitizerError(AssertionError):
    """A data-plane invariant was violated at runtime."""


def _encode_quantum() -> int:
    """Piece-length quantization used by the launch model (TILE_L)."""
    from repro_torch.kernels.gf_matmul import TILE_L
    return TILE_L


class Sanitizer:
    def __init__(self, store) -> None:
        self.store = store
        self._seen = LaunchCounter()   # launches attributed to this store
        self._budget = LaunchCounter()
        self._mark = None              # LAUNCHES snapshot of open bracket
        self._depth = 0                # tracking() reentrancy depth
        self._quantum = _encode_quantum()
        self.checks = 0  # fingerprint/launch/ledger checks performed

    # ------------------------------------------------- launch attribution --
    @contextlib.contextmanager
    def tracking(self):
        """Attribute LAUNCHES deltas inside this bracket to the store.

        Store code wraps every path that dispatches device work (window
        begin/finish, batch get, repair recode) in one of these; traffic
        from other stores between brackets is invisible to the model.
        Reentrant: nested brackets fold into the outermost one.
        """
        if self._depth == 0:
            self._mark = LAUNCHES.snapshot()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                d = LAUNCHES.delta(self._mark)
                for fam in _FAMILIES:
                    setattr(self._seen, fam,
                            getattr(self._seen, fam) + getattr(d, fam))
                self._mark = None

    def track(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under a :meth:`tracking` bracket."""
        with self.tracking():
            return fn(*args, **kwargs)

    def _observed(self) -> LaunchCounter:
        """Attributed launches, including any still-open bracket."""
        out = LaunchCounter()
        live = (LAUNCHES.delta(self._mark) if self._depth else None)
        for fam in _FAMILIES:
            setattr(out, fam, getattr(self._seen, fam)
                    + (getattr(live, fam) if live else 0))
        return out

    # ------------------------------------------------------ begin purity --
    def fingerprint(self) -> str:
        """Digest of all control-plane state a begin phase must not touch."""
        st = self.store
        h = hashlib.sha1()

        def feed(*parts) -> None:
            for p in parts:
                h.update(repr(p).encode())
                h.update(b";")

        smap = getattr(st, "shard_map", None)
        if smap is not None:
            feed(smap.topology())
        for cid, cl, info in st.index.records():
            feed(cid, cl, info.length, info.refcount)
        for user, sw in st.switching.items():
            for fname, meta in sw.table.items():
                feed(user, fname, meta.timestamp, meta.entries,
                     meta.lengths, meta.storage_class)
        for c in st.clusters:
            feed(c.cluster_id, c._reserved)
            for node in c.nodes:
                feed(node.node_id, node.alive, node.used,
                     len(node._pieces))
        for name, b in st._bindings.items():
            feed(name, sorted(getattr(b, "_bound", {}).items()),
                 getattr(b, "_next", 0))
        feed(sorted(st._logical.items()), sorted(st._nfiles.items()),
             sorted(st.repair._pending.keys()))
        cache = getattr(st, "cache", None)
        if cache is not None:
            # resident set, LRU order and the write-back queue are all
            # control-plane state: a begin seam that touches the cache
            # would break pipelined/sequential equivalence exactly like
            # an index mutation (cache reads in _plan_get happen outside
            # the guarded begins, so legitimate traffic never trips this)
            for key, data, dirty in cache.entries():
                feed(key, len(data), dirty)
            feed([(t.chunk_id, t.cluster_id, t.reserved)
                  for t in cache.queued_tasks()])
        return h.hexdigest()

    def guard_begin(self, label: str, fn: Callable, *args, **kwargs):
        before = self.fingerprint()
        out = self.track(fn, *args, **kwargs)
        after = self.fingerprint()
        self.checks += 1
        if before != after:
            raise SanitizerError(
                f"begin-phase `{label}` mutated control-plane state "
                "(index/meta/cluster/binding/repair); begin seams must "
                "be pure for pipelined windows to stay byte-identical "
                "to sequential")
        return out

    # ----------------------------------------------- expected-launch model --
    def add_budget(self, gf: int = 0, sha1: int = 0, gear: int = 0,
                   fused: int = 0) -> None:
        self._budget.gf += gf
        self._budget.sha1 += sha1
        self._budget.gear += gear
        self._budget.fused += fused

    def add_put_budget(self, codes, chunks, engine,
                       staged_hash_only: bool = False) -> None:
        """Budget one put window's hash + encode launches.

        ``codes``/``chunks`` are the window's per-chunk code objects and
        chunk bytes (parallel lists, before dedup — dedup only shrinks
        the real launch count).  ``staged_hash_only`` is the write-back
        commit: the window hashes but defers every encode (fused
        included) to the background drain, whose GF budget accrues via
        :meth:`add_writeback_budget` when the drain actually runs.
        """
        n = len(chunks)
        hash_batch = int(getattr(engine, "hash_batch", 512)) or 512
        sha1 = -(-n // hash_batch) if n else 0
        if staged_hash_only:
            self.add_budget(sha1=sha1)
            return
        buckets = {
            (code.n, code.k,
             -(-code.piece_len(len(blob)) // self._quantum))
            for code, blob in zip(codes, chunks)}
        if getattr(engine, "supports_fused_ingest", False):
            self.add_budget(fused=len(buckets))
        else:
            self.add_budget(sha1=sha1, gf=len(buckets))

    def add_writeback_budget(self, jobs) -> None:
        """Budget one write-back drain's encode launches.

        ``jobs`` is the drain's ``[(code, blob), ...]`` encode list: one
        GF launch per ``(code, quantized piece length)`` bucket, the
        same ceiling the foreground put model charges for its encodes.
        """
        buckets = {
            (code.n, code.k,
             -(-code.piece_len(len(blob)) // self._quantum))
            for code, blob in jobs}
        self.add_budget(gf=len(buckets))

    def add_repair_budget(self, n_jobs: int) -> None:
        """Budget one repair/re-placement sub-batch's recode launches.

        ``n_jobs`` chunks ride one ``recode_blobs_multi`` call: decode +
        re-encode is two GF launches per chunk as the ceiling, and
        (code, length)-bucketing merges far below it.  The same budget
        covers in-place rebuilds and cross-cluster re-placements -- a
        re-placement recode targets a *different* cluster but is still
        exactly one decode + one encode of one chunk, so "repair = 2x
        jobs" holds per job, not per (cluster, chunk) pair.  Merges and
        scrub sweeps are metadata-only: zero budget, and the model
        catches any engine traffic they would dispatch.
        """
        self.add_budget(gf=2 * n_jobs)

    def check_launches(self, label: str) -> None:
        seen = self._observed()
        self.checks += 1
        for fam in _FAMILIES:
            got, allowed = getattr(seen, fam), getattr(self._budget, fam)
            if got > allowed:
                raise SanitizerError(
                    f"launch model violated after {label}: this store "
                    f"dispatched {got} LAUNCHES.{fam} but the expected-"
                    f"launch model allows {allowed}; a data-plane path "
                    "is dispatching per-item instead of per-bucket")

    def resync(self) -> None:
        """Zero the attributed-launch ledger and its budget."""
        self._seen = LaunchCounter()
        self._budget = LaunchCounter()

    # -------------------------------------------------- ledger conservation --
    def check_ledger(self) -> None:
        st = self.store
        expected: dict[tuple[bytes, int], int] = {}
        for user, sw in st.switching.items():
            for fname, meta in sw.table.items():
                for key in set(meta.entries):
                    expected[key] = expected.get(key, 0) + 1
        recorded: dict[tuple[bytes, int], int] = {}
        for cid, cl, info in st.index.records():
            recorded[(cid, cl)] = info.refcount
        if expected != recorded:
            extra = {k: v for k, v in recorded.items()
                     if expected.get(k) != v}
            missing = {k: v for k, v in expected.items()
                       if k not in recorded}
            raise SanitizerError(
                "piece ledger out of conservation: refcounts disagree "
                f"with live file metadata ({len(extra)} record(s) with "
                f"wrong/unreferenced counts, {len(missing)} referenced "
                "but unrecorded)")
        for c in st.clusters:
            for node in c.nodes:
                for cid, idx in node._pieces:
                    if idx != node.node_id:
                        raise SanitizerError(
                            f"piece slot invariant broken: node "
                            f"{node.node_id} of cluster {c.cluster_id} "
                            f"holds piece index {idx}")
                    if (cid, c.cluster_id) not in recorded:
                        raise SanitizerError(
                            f"orphan piece: cluster {c.cluster_id} node "
                            f"{node.node_id} holds a piece of chunk "
                            f"{cid.hex()} with no live index record")
        self._check_cache_ledger(recorded)
        self._check_shard_ledger(expected)
        self.checks += 1

    def _check_cache_ledger(self, recorded) -> None:
        """Block-cache conservation, checked at every window boundary.

        Four invariants: (1) the dirty-byte ledger equals the queued
        write-back tasks' bytes exactly (an upload lost without a
        matching ``mark_clean``/``discard`` trips here); (2) the
        cached-byte budget equals the resident blobs; (3) every cached
        copy has a live index record -- a deleted chunk must leave the
        cache atomically; (4) clean entries are byte-identical to what
        decoding the cluster's own pieces yields, so a cache hit can
        never serve different bytes than a cold read (the tentpole's
        correctness claim, enforced at runtime; dirty entries have no
        pieces yet and are skipped).  Per-cluster reservations must
        also cover each dirty task's held bytes exactly -- at a window
        boundary no foreground reservation is in flight, so the only
        legitimate holders are queued write-backs.
        """
        st = self.store
        cache = getattr(st, "cache", None)
        if cache is None:
            return
        tasks = cache.queued_tasks()
        queued_bytes = sum(len(t.data) for t in tasks)
        if cache.stats.dirty_bytes != queued_bytes:
            raise SanitizerError(
                f"dirty-byte ledger out of conservation: stats say "
                f"{cache.stats.dirty_bytes} but the write-back queue "
                f"holds {queued_bytes}")
        entries = cache.entries()
        resident = sum(len(data) for _, data, _ in entries)
        if cache.stats.cached_bytes != resident:
            raise SanitizerError(
                f"cached-byte ledger out of conservation: stats say "
                f"{cache.stats.cached_bytes} but entries hold {resident}")
        checked = 0
        for (cid, cl), data, dirty in entries:
            if (cid, cl) not in recorded:
                raise SanitizerError(
                    f"cache entry for chunk {cid.hex()} on cluster {cl} "
                    "has no live index record; deletes must evict "
                    "atomically")
            if dirty or checked >= 64:  # bound the per-window decode cost
                continue
            checked += 1
            cluster = st.clusters[cl]
            pieces = cluster.read_pieces(cid, cluster.k)
            if len(pieces) >= cluster.k and (
                    cluster.code.decode_bytes(pieces, len(data)) != data):
                raise SanitizerError(
                    f"cache poisoned: clean entry for chunk {cid.hex()} "
                    f"on cluster {cl} differs from the cluster's own "
                    "decoded pieces")
        held: dict[int, int] = {}
        for t in tasks:
            held[t.cluster_id] = held.get(t.cluster_id, 0) + t.reserved
        for c in st.clusters:
            want = held.get(c.cluster_id, 0)
            if c._reserved != want:
                raise SanitizerError(
                    f"write-back reservation ledger: cluster "
                    f"{c.cluster_id} reserves {c._reserved} bytes but "
                    f"its queued write-backs hold {want}")

    def _check_shard_ledger(self, expected) -> None:
        """Per-shard conservation: every record/table on its bucket owner.

        Three invariants on a sharded store: (1) each chunk record lives
        on the shard owning its chunk-id bucket, (2) each switching
        table and binding entry lives on the shard owning its user
        bucket, (3) each shard's refcounts balance exactly the live file
        references to *its* chunks — a half-migrated bucket or a write
        routed past the owner trips here at the next window boundary.
        """
        smap = getattr(self.store, "shard_map", None)
        if smap is None:
            return
        for sid in smap.live_ids():
            shard = smap.shards[sid]
            shard_recorded: dict[tuple[bytes, int], int] = {}
            for cid, cl, info in shard.index.records():
                if smap.shard_of_chunk(cid) is not shard:
                    raise SanitizerError(
                        f"shard ledger: chunk {cid.hex()} record held by "
                        f"shard {sid} but bucket "
                        f"{smap.chunk_bucket(cid)} is owned by shard "
                        f"{smap.shard_of_chunk(cid).shard_id}")
                shard_recorded[(cid, cl)] = info.refcount
            for user in shard.tables:
                if smap.shard_of_user(user) is not shard:
                    raise SanitizerError(
                        f"shard ledger: switching table of {user!r} held "
                        f"by shard {sid}, owner is shard "
                        f"{smap.shard_of_user(user).shard_id}")
            for cls_name, table in shard.bound.items():
                for user in table:
                    if smap.shard_of_user(user) is not shard:
                        raise SanitizerError(
                            f"shard ledger: {cls_name!r} binding of "
                            f"{user!r} held by shard {sid}, owner is "
                            f"shard {smap.shard_of_user(user).shard_id}")
            shard_expected = {
                key: refs for key, refs in expected.items()
                if smap.shard_of_chunk(key[0]) is shard}
            if shard_expected != shard_recorded:
                raise SanitizerError(
                    f"per-shard ledger out of conservation on shard "
                    f"{sid}: {len(shard_recorded)} record(s) vs "
                    f"{len(shard_expected)} expected from live file "
                    "metadata")

    def check_window(self, label: str) -> None:
        self.check_launches(label)
        self.check_ledger()
