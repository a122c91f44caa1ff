"""Plan/execute pipeline types for the SEARS store.

Uploads and retrievals run in three steps:

1. **plan** (control plane, per chunk): chunk the file, resolve dedup
   against the index, choose clusters and *reserve* their space, record
   chunk-meta-data.  Pure metadata -- no bulk bytes move.
2. **execute** (data plane, per batch): hash / RS-encode / RS-decode the
   planned chunks in bulk through a ``repro_torch.core.engine.CodingEngine``,
   and move pieces to/from storage nodes with the bulk cluster APIs.
3. **commit/assemble**: write pieces and release reservations (upload) or
   reassemble file bytes from decoded chunks (retrieval), then report
   stats.

The split exists so one kernel launch amortizes over many chunks -- and,
through ``put_files``/``get_files``, over many files and users.  Plans
carry everything the execute step needs so the two phases stay decoupled.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import dedup


@dataclasses.dataclass
class EncodeTask:
    """A new unique chunk that must be encoded and stored."""

    chunk_id: bytes
    data: bytes
    cluster_id: int
    piece_len: int


@dataclasses.dataclass
class UploadPlan:
    """Control-plane result for one file upload.

    The index/meta mutations are already applied when the plan is built
    (so later files in the same batch dedup against earlier ones); only
    the data-plane work -- encoding ``encode_tasks`` and landing pieces --
    is deferred to the execute step.

    ``request_id`` tags the plan with the scheduler request that owns it,
    so cross-user coalesced batches can be demuxed and a failing request
    rolled back without touching its window neighbours; ``entries`` is
    the file's (chunk_id, cluster_id) list (the same object handed to the
    switching node's ``FileMeta``), used to decide whether this file
    references a chunk copy whose pieces failed to land.
    """

    user: str
    filename: str
    timestamp: float
    file_bytes: int
    n_chunks: int
    n_unique_in_file: int
    encode_tasks: list[EncodeTask]
    entries: list[tuple[bytes, int]] = dataclasses.field(default_factory=list)
    request_id: int = -1
    storage_class: str = "default"  # class whose policy produced this plan

    @property
    def bytes_uploaded(self) -> int:
        return sum(len(t.data) for t in self.encode_tasks)


@dataclasses.dataclass
class FetchTask:
    """One unique missing chunk to fetch (k pieces) and decode."""

    chunk_id: bytes
    cluster_id: int
    length: int  # original chunk bytes (decode target)
    piece_len: int
    pieces: dict[int, bytes] | None = None  # filled by the fetch step


@dataclasses.dataclass
class RetrievalPlan:
    """Control-plane result for one file retrieval.

    ``request_id`` tags the plan with its owning scheduler request so a
    coalesced cross-user decode batch can be demuxed per request and a
    failure (e.g. data loss) isolated to the request it belongs to.

    ``cached`` holds the chunks the switching node's block cache served
    at plan time -- they never become fetch tasks, never touch a
    cluster, and their bytes ride the fast ``cache_hit_time`` path of
    the latency model instead of ``retrieval_time``.
    """

    user: str
    filename: str
    meta: dedup.FileMeta
    fetch_tasks: list[FetchTask]
    share_bytes: dict[int, int]  # cluster -> decoded bytes (latency model)
    request_id: int = -1
    cached: dict[bytes, bytes] = dataclasses.field(default_factory=dict)

    @property
    def cached_bytes(self) -> int:
        """Bytes served from the block cache (no cluster involved)."""
        return sum(len(b) for b in self.cached.values())

    @property
    def wire_bytes(self) -> int:
        """Actual bytes pulled off storage nodes (k pieces per chunk)."""
        return sum(sum(len(p) for p in t.pieces.values())
                   for t in self.fetch_tasks if t.pieces is not None)
