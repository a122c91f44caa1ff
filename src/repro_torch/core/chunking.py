"""Content-defined chunking (CDC) with a gear rolling hash.

Paper parameters (SEARS S II): average chunk 4 KB, min 1 KB, max 8 KB.

The gear recurrence ``h_t = 2*h_{t-1} + gear[b_t] (mod 2^32)`` is linear, so

    h_t = sum_{j=0..31} 2^j * gear[b_{t-j}]   (mod 2^32)

-- a 32-tap windowed weighted sum: data-parallel, no sequential scan.
The CUDA kernel behind ``repro_torch.kernels.gear_cdc`` evaluates it
tile-wise with a 31-byte halo, and
this module provides the vectorized numpy twin used by the host storage
path plus the byte-at-a-time reference used as the test oracle.

Boundary *candidates* ``(h & MASK) == 0`` are data-parallel; the greedy
min/max chunk-size selection is inherently sequential but touches only the
sparse candidate list (~N/4096 positions), so it stays on the host.

``chunk_spans_batch`` is the batched-ingest entry point: a whole put
window (every file of every queued user) concatenates into one stream,
the rolling hash runs as a single pass (host ``gear_candidates_np`` or
one device gear launch), and per-file offset masking keeps the result
byte-identical to per-file ``Chunker.chunk_spans`` -- hash history
resets at file seams exactly like the oracle's implicit zero history.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GEAR_SEED = 0x5EA125  # fixed so chunk ids are stable across runs/hosts
_rng = np.random.RandomState(GEAR_SEED)
GEAR_TABLE = _rng.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
del _rng

WINDOW = 32  # bytes of history that influence the uint32 gear hash


_HASH_BLOCK = 1 << 16  # cache tile for the 32-tap sum (~0.5 MB working set)


def _tile_hash(data: np.ndarray, lo: int, s: int, e: int) -> np.ndarray:
    """Gear hashes for positions ``[s, e)`` given history back to ``lo``.

    ``lo`` must reach position 0 or lie at least WINDOW-1 bytes before
    ``s`` so every returned position sees its full backward window.  The
    gather and the 32 shifted adds touch only the tile, so the working
    set stays cache-resident regardless of the full stream size.
    """
    gseg = GEAR_TABLE[data[lo:e]]
    m = e - lo
    # h[t] = sum_j g[t-j] << j ; vectorized as 32 shifted adds
    hseg = np.zeros(m, dtype=np.uint32)
    for j in range(min(WINDOW, m)):
        hseg[j:] += gseg[: m - j] << np.uint32(j)
    return hseg[s - lo:]


def gear_hash_np(data: np.ndarray) -> np.ndarray:
    """Windowed-sum gear hash. (N,) uint8 -> (N,) uint32, h[t] as defined above.

    Tiled in ``_HASH_BLOCK`` segments (with a 31-entry halo) so multi-MB
    streams stay cache-resident -- untiled, each of the 32 passes
    restreams the whole array from DRAM and batched ingest loses 2-3x.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    if n <= _HASH_BLOCK:
        return _tile_hash(data, 0, 0, n)
    halo = WINDOW - 1
    h = np.empty(n, dtype=np.uint32)
    for s in range(0, n, _HASH_BLOCK):
        e = min(n, s + _HASH_BLOCK)
        h[s:e] = _tile_hash(data, max(0, s - halo), s, e)
    return h


def gear_candidates_np(data: np.ndarray, mask: np.uint32) -> np.ndarray:
    """Boundary-candidate *positions* via a fused tiled hash + mask test.

    Equivalent to ``np.flatnonzero((gear_hash_np(data) & mask) == 0)`` but
    never materializes the full hash array: each cache tile's hashes are
    tested and compacted to the sparse position list while still hot, so
    a multi-MB ingest stream costs one streaming read of the data instead
    of a hash-array write + re-read (~5 extra bytes of DRAM traffic per
    input byte).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    halo = WINDOW - 1
    out = []
    for s in range(0, n, _HASH_BLOCK):
        e = min(n, s + _HASH_BLOCK)
        pos = np.flatnonzero(
            (_tile_hash(data, max(0, s - halo), s, e) & mask) == 0)
        if pos.size:
            out.append(pos.astype(np.int64) + s)
    if not out:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(out)


def gear_hash_sequential(data: np.ndarray) -> np.ndarray:
    """Byte-at-a-time oracle: h = (h << 1) + gear[b] in uint32."""
    data = np.asarray(data, dtype=np.uint8)
    out = np.zeros(data.shape[0], dtype=np.uint32)
    h = np.uint32(0)
    for t, b in enumerate(data):
        h = np.uint32((np.uint64(h) * 2 + np.uint64(GEAR_TABLE[b])) & 0xFFFFFFFF)
        out[t] = h
    return out


@dataclasses.dataclass(frozen=True)
class Chunker:
    """Gear-CDC chunker with min/avg/max size constraints."""

    min_size: int = 1024
    avg_size: int = 4096
    max_size: int = 8192

    @property
    def mask(self) -> np.uint32:
        bits = int(np.log2(self.avg_size))
        # use the high bits of the hash (low gear bits mix poorly)
        return np.uint32(((1 << bits) - 1) << (32 - bits))

    def candidates(self, data: np.ndarray, hash_fn=gear_hash_np) -> np.ndarray:
        """Sorted cut offsets (exclusive-end positions) where the hash fires."""
        if hash_fn is gear_hash_np:  # fused tiled fast path, same result
            return gear_candidates_np(np.asarray(data, dtype=np.uint8),
                                      self.mask) + 1
        h = hash_fn(np.asarray(data, dtype=np.uint8))
        return np.flatnonzero((h & self.mask) == 0) + 1  # cut *after* byte t

    def boundaries(self, data, hash_fn=gear_hash_np) -> np.ndarray:
        """Greedy min/max-constrained cut offsets; always ends at len(data)."""
        data = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
        n = data.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        cand = self.candidates(data, hash_fn=hash_fn)
        return select_boundaries(cand, n, self.min_size, self.max_size)

    def chunk_spans(self, data, hash_fn=gear_hash_np) -> list[tuple[int, int]]:
        """[(offset, length), ...] covering the input exactly."""
        cuts = self.boundaries(data, hash_fn=hash_fn)
        spans, start = [], 0
        for c in cuts:
            spans.append((start, int(c) - start))
            start = int(c)
        return spans

    def chunk(self, data: bytes, hash_fn=gear_hash_np) -> list[bytes]:
        view = memoryview(data)
        return [bytes(view[o : o + l]) for o, l in self.chunk_spans(data, hash_fn)]


def as_bytes_array(data) -> np.ndarray:
    """Normalize a blob to a (N,) uint8 view (the chunker's input form).

    Raises for anything that is not a 1-D byte sequence (scalars, 2-D
    arrays), so batched callers can reject a malformed payload *before*
    it joins a shared stream and poisons the whole window.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    arr = np.asarray(data, np.uint8)
    if arr.ndim != 1:
        raise TypeError(f"expected a 1-D byte sequence, got shape {arr.shape}")
    return arr


@dataclasses.dataclass
class PendingSpans:
    """An issued-but-unresolved batched chunking pass (window in flight).

    Produced by ``chunk_spans_batch_begin``: the window's stream is
    concatenated and its candidate pass *issued* (one device gear launch
    on the kernel path); ``handle`` is whatever the issue function
    returned -- an unmaterialized device bitmap, or a deferred host
    closure.  ``chunk_spans_batch_finish`` resolves it to spans.
    """

    chunker: Chunker
    lengths: np.ndarray
    starts: np.ndarray
    stream: np.ndarray | None  # None for an all-empty window
    handle: object


def chunk_spans_batch_begin(chunker: Chunker, blobs: list[np.ndarray],
                            issue_fn) -> PendingSpans:
    """Issue the window's candidate pass without resolving it.

    ``issue_fn(stream, mask)`` dispatches the rolling-hash work and may
    return an unmaterialized handle (e.g. an in-flight device fire
    bitmap via ``kernels.ops.gear_fire_issue``); the host-side greedy
    selection happens at ``chunk_spans_batch_finish``.  This is the
    double-buffering seam: window *i+1*'s gear launch runs while window
    *i*'s host phases (selection, dedup planning) execute.
    """
    blobs = [as_bytes_array(b) for b in blobs]
    lengths = np.array([b.shape[0] for b in blobs], dtype=np.int64)
    if int(lengths.sum()) == 0:
        return PendingSpans(chunker=chunker, lengths=lengths,
                            starts=np.zeros_like(lengths), stream=None,
                            handle=None)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    stream = np.concatenate([b for b in blobs if b.shape[0]])
    return PendingSpans(chunker=chunker, lengths=lengths, starts=starts,
                        stream=stream,
                        handle=issue_fn(stream, chunker.mask))


def chunk_spans_batch_finish(pending: PendingSpans, resolve_fn
                             ) -> list[list[tuple[int, int]]]:
    """Resolve an issued window to per-blob spans (greedy select on host).

    ``resolve_fn(handle)`` materializes the candidate positions (sorted
    global stream offsets); the per-file seam masking and greedy min/max
    selection below are byte-identical to ``chunk_spans_batch``.
    """
    chunker, lengths = pending.chunker, pending.lengths
    if pending.stream is None:
        return [[] for _ in lengths]
    starts, stream = pending.starts, pending.stream

    fire = np.asarray(resolve_fn(pending.handle),
                      dtype=np.int64)  # sorted global positions

    halo = WINDOW - 1
    spans: list[list[tuple[int, int]]] = []
    for start, n in zip(starts, lengths):
        start, n = int(start), int(n)
        if n == 0:
            spans.append([])
            continue
        # uncontaminated candidates: local offset >= halo
        lo = int(np.searchsorted(fire, start + halo, side="left"))
        hi = int(np.searchsorted(fire, start + n, side="left"))
        cand = fire[lo:hi] - start + 1  # cut *after* byte t
        if halo and start > 0:
            # head positions see the previous file's tail in the shared
            # stream; redo them from the file's own (zero-history) head
            head = chunker.candidates(stream[start:start + min(halo, n)])
            if head.size:
                cand = np.concatenate([head.astype(np.int64), cand])
        elif halo:
            # first file: the stream head *is* its head, keep exact cands
            head_lo = int(np.searchsorted(fire, start, side="left"))
            head = fire[head_lo:lo] - start + 1
            if head.size:
                cand = np.concatenate([head, cand])
        cuts = select_boundaries(cand, n, chunker.min_size, chunker.max_size)
        out, prev = [], 0
        for c in cuts:
            out.append((prev, int(c) - prev))
            prev = int(c)
        spans.append(out)
    return spans


def chunk_spans_batch(chunker: Chunker, blobs: list[np.ndarray],
                      stream_candidates_fn=gear_candidates_np
                      ) -> list[list[tuple[int, int]]]:
    """Batched ``chunk_spans``: one rolling-hash pass over a whole window.

    All blobs are concatenated into one stream and boundary-candidate
    positions are extracted with a single ``stream_candidates_fn(stream,
    mask)`` call (``gear_candidates_np`` on the host, or one device gear
    launch via ``kernels.ops.gear_candidate_positions``).  Per-file
    boundary candidates come from the shared stream with offset masking:

    * a stream position at local offset >= WINDOW-1 sees a hash window
      that lies entirely inside its own file, so its hash value equals
      the per-file oracle's exactly;
    * the first WINDOW-1 positions of each file are contaminated by the
      previous file's tail bytes, so their candidates are recomputed from
      the file's own head (``gear_hash_np`` over <= 31 bytes) -- the
      per-file history reset the oracle gets implicitly.

    The greedy min/max selection stays per file on the sparse candidate
    list, so the returned spans are byte-identical to
    ``chunker.chunk_spans`` on every blob (the differential tests in
    ``tests/test_ingest.py`` enforce this).

    Implemented as ``begin`` + ``finish`` with an eager issue function
    and identity resolve; the split entry points exist for the
    double-buffered window pipeline.
    """
    pending = chunk_spans_batch_begin(chunker, blobs, stream_candidates_fn)
    return chunk_spans_batch_finish(pending, lambda handle: handle)


def select_boundaries(cand: np.ndarray, n: int, min_size: int,
                      max_size: int) -> np.ndarray:
    """Greedy selection over sparse candidates; sequential but O(#chunks log C)."""
    cuts = []
    start = 0
    cand = np.asarray(cand, dtype=np.int64)
    while start < n:
        if n - start <= min_size:
            cut = n
        else:
            window_end = min(start + max_size, n)
            lo = int(np.searchsorted(cand, start + min_size, side="left"))
            if lo < cand.shape[0] and cand[lo] <= window_end:
                cut = int(cand[lo])
            else:
                cut = window_end
        cuts.append(cut)
        start = cut
    return np.asarray(cuts, dtype=np.int64)


DEFAULT_CHUNKER = Chunker()
