"""Cross-user batch scheduler: the multi-user switching-node front end.

SEARS's switching node is inherently multi-tenant -- it aggregates many
users' upload/retrieval traffic before chunks ever reach the storage
clusters (paper S II), and the retrieval-time win depends on keeping that
aggregation path fast.  ``BatchScheduler`` models the aggregation:
requests from any number of users queue in a ``RequestQueue``; each
``flush()`` drains the queue and coalesces the queued requests into
*shared* data-plane batches -- one SHA-1 launch and one GF(256) launch
per length bucket across all users in the window -- then fans results
back out per request.

``SEARSStore.put_files``/``get_files``/``delete_file`` are the
batch-of-one special case: they build a single ``Request`` and push it
through the same ``_batch_put``/``_batch_get``/``_batch_delete``
machinery, so a single-user call is just a one-user flush.

Scheduler submits return :class:`RequestFuture` handles -- ``done()``,
``result()`` (re-raising the request's error), ``exception()`` -- that
resolve when the owning scheduler flushes (``flush()``/``poll()``/an
auto-flush).  Calling ``result()`` on a still-queued future flushes the
scheduler, so the future resolves in submission order with everything
queued ahead of it.  Requests carry an optional ``storage_class`` so
heterogeneous traffic (real-time and archival policies) coalesces in one
window; deletes queue as first-class ``DELETE`` requests and therefore
serialize with puts/gets in submission order.

Invariants (enforced by ``tests/test_scheduler.py``):

* **Sequential equivalence** -- a flush produces byte-identical artifacts
  (pieces on storage nodes, dedup ratio, ``StoreStats``, per-request
  stats) to issuing the same requests one at a time through
  ``put_files``/``get_files`` in submit order.  Coalescing changes launch
  counts, never bytes.
* **Per-request isolation** -- a failing request (out of storage, dead
  nodes, missing file) is rolled back atomically: no phantom metadata, no
  leaked reservations, and no effect on its window neighbours.  The one
  deliberate coupling: a request that deduplicated against a *new* chunk
  whose pieces failed to land fails too, instead of committing metadata
  that points at bytes which do not exist.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

PUT = "put"
GET = "get"
DELETE = "delete"


class AdmissionError(RuntimeError):
    """A request was shed or rejected by scheduler admission control.

    Raised *through the future* (``result()`` re-raises it), never out
    of ``submit_*`` -- the caller always gets a handle and an honest
    answer, not a silent drop.
    """


def _put_payload_bytes(files) -> int:
    """Queued put bytes for auto-flush accounting; never raises.

    A malformed pair (or payload without a length) counts zero here and
    fails only its own request at flush time -- submit must not raise
    after the request is already enqueued.
    """
    nbytes = 0
    for pair in files:
        try:
            _, data = pair
            nbytes += len(data)
        except Exception:
            continue
    return nbytes


@dataclasses.dataclass
class Request:
    """One user's queued upload, retrieval or deletion (a unit of atomicity).

    ``result`` for a put is ``list[UploadStats]``; for a get it is
    ``list[tuple[bytes, RetrievalStats]]`` in ``filenames`` order; for a
    delete it is the list of filenames removed.  ``storage_class`` names
    the :class:`repro_torch.core.classes.StorageClass` policy the request runs
    under (``None`` -> the store's default class).
    """

    request_id: int
    user: str
    kind: str  # PUT | GET | DELETE
    files: list[tuple[str, bytes]] | None = None  # put payload
    filenames: list[str] | None = None  # get/delete payload
    timestamp: float = 0.0
    local_chunk_ids: set[bytes] | None = None
    rho_fn: Callable[[int], float] | None = None
    storage_class: str | None = None
    status: str = "queued"  # queued | done | failed
    result: Any = None
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.status == "done"


class RequestFuture:
    """Handle for a submitted request; resolves at ``flush()``/``poll()``.

    Replaces callers poking ``Request.error``/``Request.result``
    directly: ``result()`` re-raises the request's failure (or returns
    its result), ``exception()`` returns it, ``done()`` reports whether
    the owning scheduler has executed the request yet.  Calling
    ``result()``/``exception()`` on a still-queued future flushes the
    scheduler -- the queue drains in submission order, so everything
    submitted before this request executes first.  The legacy
    ``status``/``ok``/``error`` views stay readable for observers that
    must not trigger a flush.

    Migration note: the old submit API returned the ``Request`` itself,
    whose ``.result`` was a data attribute.  On a future ``.result`` is
    the *method* -- old-style attribute reads must become ``result()``
    calls (or use ``future.request.result`` for the raw non-flushing
    view).
    """

    __slots__ = ("request", "_scheduler")

    def __init__(self, request: Request, scheduler: "BatchScheduler"):
        self.request = request
        self._scheduler = scheduler

    def __repr__(self) -> str:
        return (f"RequestFuture(id={self.request.request_id}, "
                f"kind={self.request.kind}, status={self.request.status})")

    # ------------------------------------------------------- future API ---
    def done(self) -> bool:
        """True once the request has been executed (successfully or not)."""
        return self.request.status in ("done", "failed")

    def result(self) -> Any:
        """The request's result; its error is re-raised here.

        Still-queued requests resolve by flushing the owning scheduler
        (submission order is preserved -- this request runs after
        everything queued before it).
        """
        self._resolve()
        if self.request.error is not None:
            raise self.request.error
        return self.request.result

    def exception(self) -> BaseException | None:
        """The request's failure, if any (resolving like ``result()``)."""
        self._resolve()
        return self.request.error

    def _resolve(self) -> None:
        if not self.done():
            self._scheduler.flush()

    # ------------------------------------- legacy non-flushing views ------
    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def user(self) -> str:
        return self.request.user

    @property
    def kind(self) -> str:
        return self.request.kind

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def ok(self) -> bool:
        return self.request.ok

    @property
    def error(self) -> BaseException | None:
        """The recorded failure *without* resolving (no flush)."""
        return self.request.error


class RequestQueue:
    """FIFO of pending requests with monotonically increasing ids."""

    def __init__(self) -> None:
        self._pending: list[Request] = []
        self._next_id = 0

    def __len__(self) -> int:
        return len(self._pending)

    def _submit(self, req: Request) -> Request:
        self._pending.append(req)
        return req

    def submit_put(self, user: str, files: list[tuple[str, bytes]],
                   timestamp: float = 0.0,
                   storage_class: str | None = None) -> Request:
        req = Request(request_id=self._next_id, user=user, kind=PUT,
                      files=list(files), timestamp=timestamp,
                      storage_class=storage_class)
        self._next_id += 1
        return self._submit(req)

    def submit_get(self, user: str, filenames: list[str],
                   local_chunk_ids: set[bytes] | None = None,
                   rho_fn: Callable[[int], float] | None = None,
                   storage_class: str | None = None) -> Request:
        req = Request(request_id=self._next_id, user=user, kind=GET,
                      filenames=list(filenames),
                      local_chunk_ids=local_chunk_ids, rho_fn=rho_fn,
                      storage_class=storage_class)
        self._next_id += 1
        return self._submit(req)

    def submit_delete(self, user: str, filenames: list[str]) -> Request:
        req = Request(request_id=self._next_id, user=user, kind=DELETE,
                      filenames=list(filenames))
        self._next_id += 1
        return self._submit(req)

    def remove(self, req: Request) -> None:
        """Withdraw a still-queued request (admission-control shedding)."""
        self._pending.remove(req)

    def drain(self) -> list[Request]:
        pending, self._pending = self._pending, []
        return pending


@dataclasses.dataclass
class SchedulerStats:
    """Cumulative flush accounting (data-plane launches via kernels.ops)."""

    n_flushes: int = 0
    n_requests: int = 0
    n_failed: int = 0
    n_put_windows: int = 0  # coalesced put batches executed
    n_get_windows: int = 0
    n_delete_windows: int = 0
    n_auto_flushes: int = 0  # flushes triggered by size/interval thresholds
    n_pipelined_windows: int = 0  # put windows whose chunk pass was issued
    #                               ahead, overlapping the previous window
    n_shard_subwindows: int = 0  # per-shard data-plane sub-windows the
    #                              put/get windows demuxed into (equals the
    #                              window count on a 1-shard store)
    gf_launches: int = 0  # GF(256) launches issued during flushes
    sha1_launches: int = 0
    gear_launches: int = 0  # device chunking launches issued during flushes
    fused_launches: int = 0  # fused hash+encode ingest launches
    flush_seconds: float = 0.0
    # background repair lane (bounded drain of the store's repair queue
    # after each flush window; launch counts kept separate from the
    # foreground counters above so coalescing benchmarks stay comparable)
    n_repair_windows: int = 0  # flushes that ran a repair drain
    repair_chunks: int = 0  # chunk copies classified by the lane
    repair_pieces_rebuilt: int = 0
    repair_pieces_replaced: int = 0  # pieces landed on re-placement targets
    repair_deferred: int = 0  # drain items pushed back by the bandwidth budget
    repair_gf_launches: int = 0  # GF launches spent on repair recodes
    repair_seconds: float = 0.0
    # proactive scrub lane (timer-driven sampled censuses feeding the
    # repair queue; pure metadata, zero data-plane launches)
    n_scrub_sweeps: int = 0
    scrub_chunks_censused: int = 0
    scrub_enqueued: int = 0  # chunk copies the sweeps newly queued
    # background write-back lane (bounded drain of the block cache's
    # upload queue after each flush's foreground windows commit)
    n_writeback_windows: int = 0  # flushes that drained write-back chunks
    writeback_chunks: int = 0  # chunks the lane landed on clusters
    writeback_seconds: float = 0.0
    # per-class admission control (lanes=True + queue limits)
    n_admission_shed: int = 0  # queued lower-priority requests withdrawn
    n_admission_rejected: int = 0  # incoming requests refused outright

    @property
    def data_plane_launches(self) -> int:
        return (self.gf_launches + self.sha1_launches + self.gear_launches
                + self.fused_launches)


class BatchScheduler:
    """Coalesces many users' requests into shared data-plane batches.

    Requests are drained in submit order and grouped into maximal
    consecutive same-kind runs; each run becomes one coalesced
    ``_batch_put``/``_batch_get``/``_batch_delete`` window, so the
    all-puts-then-all-gets pattern collapses to exactly two windows while
    mixed traffic keeps its ordering (a get submitted after a put -- or
    after a delete -- in the same flush still observes it).  Submits
    return :class:`RequestFuture` handles; a window may mix storage
    classes, and the shared batches bucket by (code, length) so the
    launch count stays O(code buckets x length buckets).  On a sharded
    store (``SEARSStore(shards=N)``) each put/get window further
    demuxes its data-plane batches into per-shard sub-windows whose
    device passes are issued back-to-back (concurrently in flight);
    ``SchedulerStats.n_shard_subwindows`` counts them, and the bucket
    bound above holds *per shard sub-window*.

    **Auto-flush**: with ``flush_bytes`` set, a submit that lifts the
    pending put payload to/over the threshold flushes the whole queue
    immediately; with ``flush_interval`` set, a submit arriving more than
    that many seconds after the window's first pending request does the
    same (submit-driven -- no background thread; call ``poll()`` from an
    external ticker to close out an idle window).  Auto-flushed windows
    run the exact same ``flush()`` path, so they are byte-identical to
    manual flushes of the same queue.

    **Repair lane**: with ``repair_chunks_per_flush`` set, each flush ends
    with a bounded background repair window -- up to that many queued
    chunks (read-repair hints plus anything a scan enqueued on
    ``store.repair``) are drained through the batched repair path after
    the foreground put/get windows commit.  The bound is what keeps
    repair from starving user traffic during a failure storm: foreground
    latency pays at most one sub-batch-sized recode per flush, and the
    queue's most-at-risk-first order means the bounded budget always goes
    to the chunks closest to data loss.  Repair launch counts and timings
    land in separate ``SchedulerStats`` fields so foreground coalescing
    metrics stay honest.

    **Scrub lane**: with ``scrub_interval`` set, the scheduler runs a
    proactive ``store.repair.scrub()`` sweep whenever the (injectable)
    clock says at least that many seconds have passed since the last one
    -- checked at each flush and each ``poll()``, so an external ticker
    keeps scrubbing an otherwise idle store.  ``scrub_budget`` passes
    through to :meth:`RepairManager.scrub` (per-class census budgets).
    The sweep runs *before* the flush's repair drain, so damage it finds
    can heal in the same flush's bounded repair window.
    """

    def __init__(self, store, queue: RequestQueue | None = None,
                 flush_bytes: int | None = None,
                 flush_interval: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 repair_chunks_per_flush: int | None = None,
                 scrub_interval: float | None = None,
                 scrub_budget=None,
                 pipeline: bool = True,
                 lanes: bool = False,
                 max_pending: int | None = None,
                 max_queue_bytes: int | None = None,
                 writeback_bytes_per_flush: int | None = None) -> None:
        self.store = store
        self.queue = queue or RequestQueue()
        self.stats = SchedulerStats()
        self.flush_bytes = flush_bytes
        self.flush_interval = flush_interval
        self._clock = clock
        self._pending_bytes = 0
        self._window_opened: float | None = None
        self.repair_chunks_per_flush = repair_chunks_per_flush
        self.scrub_interval = scrub_interval
        self.scrub_budget = scrub_budget  # int | {class: int} | None
        self._last_scrub = clock()
        # per-class priority lanes: with lanes=True each flush reorders
        # its drained queue by (storage-class priority, request_id)
        # before windowing -- realtime traffic preempts archival inside
        # the flush.  This deliberately trades the scheduler's default
        # cross-class submission-order guarantee for latency (ordering
        # *within* a class is still submission order; leave lanes off if
        # cross-class read-your-writes matters).
        self.lanes = lanes
        # admission control: when the queue exceeds these limits at
        # submit, strictly-lower-priority queued requests are shed
        # (newest first) to make room; if none can be shed the incoming
        # request itself is rejected.  Both resolve through the future
        # as AdmissionError -- honest rejection, not silent drops.
        self.max_pending = max_pending
        self.max_queue_bytes = max_queue_bytes
        # write-back lane: bytes of dirty chunk data drained from the
        # store's block cache per flush window (None = drain fully)
        self.writeback_bytes_per_flush = writeback_bytes_per_flush
        # double-buffer put windows within a flush: issue window i+1's
        # device chunking pass before window i's host phases run.  The
        # begin phase touches no store state, so results stay
        # byte-identical to pipeline=False (sequential-equivalence tests
        # cover both settings).
        self.pipeline = pipeline

    # ------------------------------------------------------------- submit --
    def submit_put(self, user: str, files: list[tuple[str, bytes]],
                   timestamp: float = 0.0,
                   storage_class: str | None = None) -> RequestFuture:
        req = self.queue.submit_put(user, files, timestamp=timestamp,
                                    storage_class=storage_class)
        future = RequestFuture(req, self)
        # count from the queue's materialized copy -- the caller's `files`
        # may be a generator the queue already exhausted
        self._note_submit(_put_payload_bytes(req.files), req)
        return future

    def submit_get(self, user: str, filenames: list[str],
                   local_chunk_ids: set[bytes] | None = None,
                   rho_fn: Callable[[int], float] | None = None,
                   storage_class: str | None = None) -> RequestFuture:
        req = self.queue.submit_get(user, filenames,
                                    local_chunk_ids=local_chunk_ids,
                                    rho_fn=rho_fn,
                                    storage_class=storage_class)
        future = RequestFuture(req, self)
        self._note_submit(0, req)
        return future

    def submit_delete(self, user: str,
                      filenames: list[str]) -> RequestFuture:
        """Queue a delete so it serializes with pending puts/gets.

        A direct ``store.delete_file`` call executes immediately -- it
        can land *before* an already-submitted-but-unflushed get and
        change that get's result versus sequential execution.  Submitting
        the delete keeps the whole history in submission order.
        """
        req = self.queue.submit_delete(user, filenames)
        future = RequestFuture(req, self)
        self._note_submit(0, req)
        return future

    def _note_submit(self, nbytes: int, req: Request | None = None) -> None:
        if self._window_opened is None:
            self._window_opened = self._clock()
        self._pending_bytes += nbytes
        if req is not None and not self._admit(req, nbytes):
            return  # rejected: a dead request must not trigger a flush
        if self._should_auto_flush():
            self.stats.n_auto_flushes += 1
            self.flush()

    # -------------------------------------------------- admission control --
    def _priority(self, req: Request) -> int:
        """Lane priority of a request's storage class (lower runs first).

        DELETEs (and unknown class names, which fail at flush anyway)
        ride the store default class's lane.
        """
        try:
            cls = self.store._class(req.storage_class)
        except Exception:
            cls = self.store.default_class
        return getattr(cls, "priority", 1)

    def _over_limits(self) -> bool:
        if self.max_pending is not None and \
                len(self.queue) > self.max_pending:
            return True
        return (self.max_queue_bytes is not None
                and self._pending_bytes > self.max_queue_bytes)

    def _admit(self, req: Request, nbytes: int) -> bool:
        """Shed/reject under backpressure; True if ``req`` stays queued.

        While the queue is over ``max_pending``/``max_queue_bytes``,
        queued requests of *strictly lower* priority than the incoming
        one are withdrawn (lowest-importance, newest first) and failed
        with :class:`AdmissionError`; if the queue is still over after
        no more victims exist, the incoming request itself is rejected.
        Equal-priority traffic is never preempted -- overload inside one
        class rejects the newcomer, preserving FIFO fairness.
        """
        if self.max_pending is None and self.max_queue_bytes is None:
            return True
        prio = self._priority(req)
        while self._over_limits():
            victim = None
            for cand in self.queue._pending:
                if cand is req:
                    continue
                cp = self._priority(cand)
                if cp <= prio:
                    continue
                if victim is None or (cp, cand.request_id) > \
                        (self._priority(victim), victim.request_id):
                    victim = cand
            if victim is None:
                break
            self.queue.remove(victim)
            if victim.kind == PUT and victim.files:
                self._pending_bytes -= _put_payload_bytes(victim.files)
            victim.status = "failed"
            victim.error = AdmissionError(
                f"request {victim.request_id} ({victim.kind}, class="
                f"{victim.storage_class or 'default'}) shed by higher-"
                "priority traffic under queue backpressure")
            self.stats.n_admission_shed += 1
        if not self._over_limits():
            return True
        self.queue.remove(req)
        self._pending_bytes -= nbytes
        req.status = "failed"
        req.error = AdmissionError(
            f"request {req.request_id} ({req.kind}, class="
            f"{req.storage_class or 'default'}) rejected: scheduler "
            "queue is over its admission limits")
        self.stats.n_admission_rejected += 1
        return False

    def _should_auto_flush(self) -> bool:
        if self.flush_bytes is not None and \
                self._pending_bytes >= self.flush_bytes:
            return True
        return (self.flush_interval is not None
                and self._window_opened is not None
                and self._clock() - self._window_opened
                >= self.flush_interval)

    def poll(self) -> list[Request]:
        """Flush if a time-triggered window has expired (external ticker).

        Also advances the timer-driven background lanes: a due scrub
        sweep runs (and its findings drain through the bounded repair
        window) even when no foreground window expires -- an idle store
        still heals.
        """
        if len(self.queue) and self.flush_interval is not None \
                and self._should_auto_flush():
            self.stats.n_auto_flushes += 1
            return self.flush()
        if self._scrub_window():
            self._repair_window()
        self._writeback_window()
        return []

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def pending_bytes(self) -> int:
        """Put payload bytes queued in the current window."""
        return self._pending_bytes

    # -------------------------------------------------------------- flush --
    def flush(self) -> list[Request]:
        """Run every queued request through shared data-plane batches.

        Returns the drained requests, each marked ``done`` (``result``
        set) or ``failed`` (``error`` set) -- flush itself never raises on
        a per-request failure.
        """
        from repro_torch.kernels.launches import LAUNCHES  # dep-free counters

        requests = self.queue.drain()
        self._pending_bytes = 0
        self._window_opened = None
        if not requests:
            self._scrub_window()  # idle flush still advances the
            self._repair_window()  # background scrub/repair/write-back
            self._writeback_window()
            return []
        before = LAUNCHES.snapshot()
        t0 = time.perf_counter()
        if self.lanes:
            # priority lanes: realtime preempts archival inside this
            # flush (stable sort -- within a class, submission order
            # holds; across classes it deliberately does not)
            requests = sorted(requests,
                              key=lambda r: (self._priority(r),
                                             r.request_id))
        windows = self._windows(requests)
        # pipelined put ingest: PutWindowState for put windows whose
        # chunk pass was issued ahead of their execution slot.  Beginning
        # a put window reads no store state, so issuing it early -- even
        # across an intervening get/delete window -- cannot change any
        # window's outcome.
        begun: dict[int, object] = {}
        # per-shard sub-window accounting: a put/get window on a sharded
        # store demuxes its data-plane batches by owning user shard, and
        # the begin seam issues every shard's device pass back-to-back
        # (concurrent in-flight launches); count the demux so launch
        # economics stay auditable per shard window
        demux = getattr(self.store, "window_shards", None)
        for j, window in enumerate(windows):
            try:
                if window[0].kind == PUT:
                    state = begun.pop(j, None)
                    if state is None:
                        state = self.store._put_window_begin(window)
                    if self.pipeline:
                        for j2 in range(j + 1, len(windows)):
                            if windows[j2][0].kind == PUT:
                                begun[j2] = self.store._put_window_begin(
                                    windows[j2])
                                self.stats.n_pipelined_windows += 1
                                break
                    self.store._put_window_finish(state)
                    self.stats.n_put_windows += 1
                    if demux is not None:
                        self.stats.n_shard_subwindows += len(
                            demux([r.user for r in window]))
                elif window[0].kind == GET:
                    self.store._batch_get(window)
                    self.stats.n_get_windows += 1
                    if demux is not None:
                        self.stats.n_shard_subwindows += len(
                            demux([r.user for r in window]))
                else:
                    self.store._batch_delete(window)
                    self.stats.n_delete_windows += 1
            except Exception as exc:
                # backstop: _batch_put/_batch_get record per-request
                # failures themselves, but if one raises anyway no request
                # in the drained window may be silently lost
                for r in window:
                    if r.status == "queued":
                        r.status, r.error = "failed", exc
        delta = LAUNCHES.delta(before)
        self.stats.n_flushes += 1
        self.stats.n_requests += len(requests)
        self.stats.n_failed += sum(1 for r in requests if not r.ok)
        self.stats.gf_launches += delta.gf
        self.stats.sha1_launches += delta.sha1
        self.stats.gear_launches += delta.gear
        self.stats.fused_launches += delta.fused
        self.stats.flush_seconds += time.perf_counter() - t0
        self._scrub_window()
        self._repair_window()
        self._writeback_window()
        return requests

    def _scrub_window(self) -> bool:
        """Timer lane: run a proactive scrub sweep when one is due.

        Returns True when a sweep ran.  Pure metadata -- any damage found
        is queued for the repair lane that follows.
        """
        manager = getattr(self.store, "repair", None)
        if self.scrub_interval is None or manager is None:
            return False
        now = self._clock()
        if now - self._last_scrub < self.scrub_interval:
            return False
        self._last_scrub = now
        report = manager.scrub(self.scrub_budget)
        self.stats.n_scrub_sweeps += 1
        self.stats.scrub_chunks_censused += report.n_censused
        self.stats.scrub_enqueued += report.n_enqueued
        return True

    def _repair_window(self) -> None:
        """Background lane: drain a bounded slice of the repair queue.

        Runs after the foreground windows commit (so repair reads observe
        this flush's writes) and repairs at most
        ``repair_chunks_per_flush`` chunks -- one bounded recode batch
        interleaved between user flushes, never a storm-sized stall.
        """
        from repro_torch.kernels.launches import LAUNCHES

        manager = getattr(self.store, "repair", None)
        if not self.repair_chunks_per_flush or manager is None \
                or not manager.pending:
            return
        before = LAUNCHES.snapshot()
        t0 = time.perf_counter()
        report = manager.drain(max_chunks=self.repair_chunks_per_flush)
        self.stats.n_repair_windows += 1
        self.stats.repair_chunks += report.n_chunks
        self.stats.repair_pieces_rebuilt += report.pieces_rebuilt
        self.stats.repair_pieces_replaced += report.pieces_replaced
        self.stats.repair_deferred += report.deferred
        self.stats.repair_gf_launches += LAUNCHES.delta(before).gf
        self.stats.repair_seconds += time.perf_counter() - t0

    def _writeback_window(self) -> None:
        """Background lane: drain the block cache's upload queue.

        Runs after the foreground windows (and the repair lane) of every
        flush and every ``poll()``, landing up to
        ``writeback_bytes_per_flush`` bytes of dirty chunks on their
        clusters (``None`` drains fully).  The put that queued each
        chunk already acknowledged at cache-commit time -- this lane is
        where the deferred encode+store cost is actually paid, outside
        any request's latency.
        """
        cache = getattr(self.store, "cache", None)
        if cache is None or not cache.dirty_count:
            return
        t0 = time.perf_counter()
        n = self.store.drain_writeback(
            max_bytes=self.writeback_bytes_per_flush)
        if n:
            self.stats.n_writeback_windows += 1
            self.stats.writeback_chunks += n
        self.stats.writeback_seconds += time.perf_counter() - t0

    @staticmethod
    def _windows(requests: list[Request]) -> list[list[Request]]:
        windows: list[list[Request]] = []
        for req in requests:
            if windows and windows[-1][0].kind == req.kind:
                windows[-1].append(req)
            else:
                windows.append([req])
        return windows
