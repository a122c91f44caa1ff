"""Storage nodes, clusters and switching nodes (paper S II, Fig. 1).

``StorageNode`` is an in-process stand-in for one server: it holds code
pieces keyed by (chunk_id, piece_index), enforces a capacity, and can be
killed / revived / marked slow for fault-tolerance and straggler tests.

``Cluster`` groups n nodes; exactly one code piece of every chunk bound to
the cluster lives on each node.  Any node can act as the *coding node* for
a chunk (we pick one deterministically from the chunk id, which also
balances coding load).  Each cluster carries its *own* ``(n, k)`` erasure
code -- a heterogeneous store mixes pools of differently configured
clusters (storage classes), so retrieval, deletion and repair must
resolve the code from the owning cluster, never from a store-wide
global.

``SwitchingNode`` is the per-user entry point: it owns the user's
chunk-meta-data-table and answers "which of these chunk ids are missing"
during upload (inter-file dedup) and serves file chunk-meta-data during
retrieval.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import dedup
from repro_torch.core.rs_code import RSCode


class CapacityError(RuntimeError):
    pass


class NodeDownError(RuntimeError):
    pass


class PieceConflictError(RuntimeError):
    """A re-put carried *different* bytes for an existing piece slot."""


@dataclasses.dataclass
class StorageNode:
    node_id: int
    capacity: int  # bytes
    alive: bool = True
    slow_factor: float = 1.0  # >1 models a straggler
    used: int = 0

    def __post_init__(self) -> None:
        self._pieces: dict[tuple[bytes, int], bytes] = {}

    def put(self, chunk_id: bytes, piece_idx: int, piece: bytes) -> None:
        if not self.alive:
            raise NodeDownError(f"node {self.node_id} is down")
        key = (chunk_id, piece_idx)
        if key in self._pieces:
            # idempotent only for byte-identical content: a re-put that
            # carries different bytes is a coding/repair bug that would
            # otherwise corrupt the piece silently
            if self._pieces[key] != piece:
                raise PieceConflictError(
                    f"node {self.node_id}: conflicting re-put of chunk "
                    f"{chunk_id.hex()} piece {piece_idx}")
            return
        if self.used + len(piece) > self.capacity:
            raise CapacityError(f"node {self.node_id} full")
        self._pieces[key] = piece
        self.used += len(piece)

    def get(self, chunk_id: bytes, piece_idx: int) -> bytes:
        if not self.alive:
            raise NodeDownError(f"node {self.node_id} is down")
        return self._pieces[(chunk_id, piece_idx)]

    def has(self, chunk_id: bytes, piece_idx: int) -> bool:
        return self.alive and (chunk_id, piece_idx) in self._pieces

    def delete(self, chunk_id: bytes, piece_idx: int) -> None:
        piece = self._pieces.pop((chunk_id, piece_idx), None)
        if piece is not None:
            self.used -= len(piece)

    def wipe(self) -> None:
        """Factory-reset the node (replacement hardware): drop all pieces."""
        self._pieces.clear()
        self.used = 0

    @property
    def free(self) -> int:
        return self.capacity - self.used


@dataclasses.dataclass(frozen=True)
class ChunkHealth:
    """Per-chunk survivorship snapshot from :meth:`Cluster.piece_census`.

    ``holders`` are alive nodes currently serving their piece (the decode
    survivor set); ``missing`` are alive nodes whose piece is absent (the
    rebuild targets of an in-place repair pass); ``lost`` are dead nodes
    whose piece is *gone* (wiped before death, or the whole cluster was
    declared lost) -- they can neither serve reads nor accept writes, so
    only cross-cluster re-placement can restore their redundancy.  Dead
    nodes still holding their piece appear in none of the three: a revive
    brings the piece back intact.  A replaced (wiped) or declared-lost
    node is therefore never a holder -- its slot is ``missing`` while the
    node is alive-and-empty, ``lost`` once it is down-and-empty.
    """

    holders: tuple[int, ...]
    missing: tuple[int, ...]
    lost: tuple[int, ...] = ()

    @property
    def whole(self) -> bool:
        """No alive node is missing its piece -- nothing to rebuild."""
        return not self.missing

    def recoverable(self, k: int) -> bool:
        return len(self.holders) >= k


class Cluster:
    """n storage nodes holding one code piece each per bound chunk.

    ``k`` (default ``n // 2``, the seed store's shape) fixes the cluster's
    own ``(n, k)`` erasure code; ``code`` is the codec every consumer --
    retrieval, repair, local-cache rebuilds -- must use for chunks bound
    here.
    """

    def __init__(self, cluster_id: int, n: int, node_capacity: int,
                 k: int | None = None) -> None:
        self.cluster_id = cluster_id
        self.nodes = [StorageNode(node_id=i, capacity=node_capacity)
                      for i in range(n)]
        self.n = n
        self.k = max(1, n // 2) if k is None else k
        self.code = RSCode(self.n, self.k)  # validates k <= n
        self._reserved = 0  # bytes promised to planned-but-unwritten chunks
        self.lost = False  # whole-cluster disaster: all pieces gone forever

    def reserve(self, nbytes: int) -> None:
        """Earmark capacity for a planned chunk whose pieces land later.

        The plan/execute pipeline defers piece writes until a whole batch
        is encoded; reservations keep ``free`` (and therefore binding
        decisions) identical to the immediate-write sequential path.
        """
        self._reserved += nbytes

    def release_reservation(self, nbytes: int) -> None:
        self._reserved = max(0, self._reserved - nbytes)

    def coding_node(self, chunk_id: bytes) -> int:
        """Deterministic coding-node choice; spreads coding load."""
        return int.from_bytes(chunk_id[:4], "big") % self.n

    def store_chunk(self, chunk_id: bytes, pieces: list[bytes],
                    min_pieces: int | None = None) -> None:
        """Store one piece per node.  Dead nodes are skipped (degraded
        write -- reliability is reduced until ``repair_cluster`` runs) as
        long as at least ``min_pieces`` (default: all n) land."""
        if len(pieces) != self.n:
            raise ValueError(f"expected {self.n} pieces, got {len(pieces)}")
        stored = 0
        for node, piece in zip(self.nodes, pieces):
            if node.alive:
                node.put(chunk_id, node.node_id, piece)
                stored += 1
        need = self.n if min_pieces is None else min_pieces
        if stored < need:
            raise NodeDownError(
                f"cluster {self.cluster_id}: only {stored} alive nodes, "
                f"need {need}")

    def store_chunks(self, items: list[tuple[bytes, list[bytes]]],
                     min_pieces: int | None = None,
                     reserved: int = 0) -> None:
        """Bulk write: one ``store_chunk`` per (chunk_id, pieces) item.

        ``reserved`` bytes previously claimed via :meth:`reserve` for this
        batch are released whether or not every write lands, so a failed
        degraded write cannot leak capacity forever.
        """
        try:
            for chunk_id, pieces in items:
                self.store_chunk(chunk_id, pieces, min_pieces=min_pieces)
        finally:
            self.release_reservation(reserved)

    def read_pieces(self, chunk_id: bytes, want: int) -> dict[int, bytes]:
        """Collect up to ``want`` pieces from alive nodes holding them."""
        out: dict[int, bytes] = {}
        for node in self.nodes:
            if len(out) >= want:
                break
            if node.has(chunk_id, node.node_id):
                out[node.node_id] = node.get(chunk_id, node.node_id)
        return out

    def read_pieces_batch(self, chunk_ids: list[bytes], want: int
                          ) -> dict[bytes, dict[int, bytes]]:
        """Bulk read: up to ``want`` pieces for every chunk id.

        Walks the nodes once (one bulk request per node rather than one
        request per chunk per node) and returns per-chunk piece maps with
        exactly the same piece selection as serial :meth:`read_pieces`
        calls -- node order decides which k pieces are used.
        """
        out: dict[bytes, dict[int, bytes]] = {cid: {} for cid in chunk_ids}
        pending = set(out)
        for node in self.nodes:
            if not pending:
                break
            for cid in list(pending):
                if node.has(cid, node.node_id):
                    out[cid][node.node_id] = node.get(cid, node.node_id)
                    if len(out[cid]) >= want:
                        pending.discard(cid)
        return out

    def piece_census(self, chunk_ids: list[bytes]
                     ) -> dict[bytes, ChunkHealth]:
        """Bulk survivor / missing-piece scan for a set of chunks.

        One walk over the nodes (one bulk health request per node, the
        same wire pattern as :meth:`read_pieces_batch`) classifying every
        (chunk, node) slot: alive-and-holding -> ``holders``,
        alive-without-piece -> ``missing``, dead -> neither.  The repair
        planner prioritizes by ``len(holders)`` and targets ``missing``.
        """
        holders: dict[bytes, list[int]] = {cid: [] for cid in chunk_ids}
        missing: dict[bytes, list[int]] = {cid: [] for cid in chunk_ids}
        lost: dict[bytes, list[int]] = {cid: [] for cid in chunk_ids}
        for node in self.nodes:
            if not node.alive:
                # a dead node that lost its piece (wiped replacement that
                # died again, or a declared-lost cluster) can never serve
                # it back on revive -- surface the slot as `lost` so the
                # repair planner can tell "down but intact" from "gone"
                for cid in holders:
                    if (cid, node.node_id) not in node._pieces:
                        lost[cid].append(node.node_id)
                continue
            for cid in holders:
                if node.has(cid, node.node_id):
                    holders[cid].append(node.node_id)
                else:
                    missing[cid].append(node.node_id)
        return {cid: ChunkHealth(holders=tuple(holders[cid]),
                                 missing=tuple(missing[cid]),
                                 lost=tuple(lost[cid]))
                for cid in chunk_ids}

    def delete_chunk(self, chunk_id: bytes) -> None:
        for node in self.nodes:
            node.delete(chunk_id, node.node_id)

    @property
    def free(self) -> int:
        return sum(node.free for node in self.nodes) - self._reserved

    @property
    def used(self) -> int:
        return sum(node.used for node in self.nodes)

    @property
    def capacity(self) -> int:
        return sum(node.capacity for node in self.nodes)

    def kill_nodes(self, ids: list[int]) -> None:
        for i in ids:
            self.nodes[i].alive = False

    def revive_nodes(self, ids: list[int]) -> None:
        if self.lost:
            raise NodeDownError(
                f"cluster {self.cluster_id} was declared lost; its nodes "
                "cannot come back (admit a fresh cluster instead)")
        for i in ids:
            self.nodes[i].alive = True

    def declare_lost(self) -> None:
        """Whole-cluster disaster: every node down, every piece gone.

        Models losing a datacenter/availability zone: the hardware is
        unreachable *and* unrecoverable, so all pieces are wiped (unlike
        ``kill_nodes``, whose pieces survive a revive).  A lost cluster
        refuses revives; recovery is cross-cluster re-placement of its
        chunks plus :meth:`SEARSStore.admit_cluster` for fresh capacity.
        Idempotent.
        """
        for node in self.nodes:
            node.wipe()
            node.alive = False
        self._reserved = 0
        self.lost = True

    def viable(self, need_bytes: int = 0) -> bool:
        """Can this cluster accept a re-placed chunk right now?

        Not lost, at least ``k`` alive nodes (a rebuilt chunk must land
        with decodable redundancy), and ``need_bytes`` of free capacity.
        """
        return (not self.lost and self.alive_count() >= self.k
                and self.free >= need_bytes)

    def replace_nodes(self, ids: list[int]) -> None:
        """Swap failed nodes for factory-fresh replacements.

        The replacement comes up alive but *empty* -- its pieces are gone
        until a repair pass rebuilds them (degraded redundancy window).
        """
        for i in ids:
            self.nodes[i].wipe()
            self.nodes[i].alive = True

    def set_stragglers(self, ids: list[int], factor: float) -> None:
        for i in ids:
            self.nodes[i].slow_factor = factor

    def alive_count(self) -> int:
        return sum(1 for node in self.nodes if node.alive)


class SwitchingNode:
    """Per-user SEARS entry point holding the chunk-meta-data-table."""

    def __init__(self, user: str) -> None:
        self.user = user
        self.table: dict[str, dedup.FileMeta] = {}

    def put_meta(self, filename: str, meta: dedup.FileMeta) -> None:
        """Timestamp-latest-wins synchronization (paper S II)."""
        old = self.table.get(filename)
        if old is None or meta.timestamp >= old.timestamp:
            self.table[filename] = meta

    def get_meta(self, filename: str) -> dedup.FileMeta:
        return self.table[filename]

    def drop_meta(self, filename: str) -> dedup.FileMeta:
        return self.table.pop(filename)

    def missing_chunks(self, chunk_ids: list[bytes], index: dedup.ChunkIndex,
                       scope=None) -> list[bytes]:
        """Inter-file dedup: which ids must the end device upload?"""
        return [cid for cid in chunk_ids if index.lookup(cid, scope) is None]

    @property
    def meta_bytes(self) -> int:
        return sum(m.meta_bytes for m in self.table.values())
