"""R-ADMAD baseline (Liu et al., ICS'09) -- the paper's comparison system.

R-ADMAD packs variable-length deduplicated chunks into **fixed-size
containers** (paper: 8 MB), erasure-codes each container across a
*redundancy group* of nodes, and indexes chunks as (container, offset,
length).  Differences from SEARS that drive the measured gaps:

* Dedup is system-wide (like CLB) so space efficiency is close to CLB, but
  the per-chunk index record is bigger (container + offset + length) and
  sealed containers carry padding -> slightly worse dedup ratio (Fig 3c).
* Retrieval has no k-of-n race: a chunk lives at a *specific* offset of a
  *specific* container, so the client reads the systematic piece(s) that
  cover it (stripe-unit aligned -> read amplification) and must wait for
  **those** nodes -- a max over required nodes rather than a k-th order
  statistic -> tail- and load-sensitive latency (Fig 3b/3d).  Degraded
  reads (node down) fall back to fetching any k pieces of the whole
  container and decoding it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dedup, hashing
from repro_torch.core.chunking import DEFAULT_CHUNKER, Chunker
from repro_torch.core.cluster import Cluster
from repro_torch.core.latency import LatencyParams
from repro_torch.core.rs_code import RSCode
from repro_torch.core.store import RetrievalStats, StoreStats, UploadStats

CHUNK_RECORD_BYTES = 20 + 8 + 4 + 4  # id + container + offset + length
CONTAINER_RECORD_BYTES = 8 + 4 + 4  # container id + cluster + seal state


@dataclasses.dataclass
class _ChunkLoc:
    container: int
    offset: int
    length: int
    refcount: int = 0


class RADMADStore:
    """Container-packing dedup + EC store with the SEARSStore API surface."""

    def __init__(self, n: int = 10, k: int = 5, num_clusters: int = 20,
                 node_capacity: int = 1 << 30,
                 container_size: int = 8 << 20, stripe_unit: int = 64 << 10,
                 chunker: Chunker = DEFAULT_CHUNKER,
                 latency: LatencyParams | None = None, seed: int = 0,
                 hash_fn=hashing.chunk_id) -> None:
        self.code = RSCode(n, k)
        self.n, self.k = n, k
        self.container_size = container_size
        self.stripe_unit = stripe_unit
        self.chunker = chunker
        self.clusters = [Cluster(i, n, node_capacity, k=k)
                         for i in range(num_clusters)]
        self.latency = latency or LatencyParams()
        self.rng = np.random.default_rng(seed)
        self.hash_fn = hash_fn

        self._chunks: dict[bytes, _ChunkLoc] = {}
        self._container_cluster: dict[int, int] = {}
        self._open_buf = bytearray()
        self._open_entries: list[tuple[bytes, int, int]] = []
        self._next_container = 0
        self.files: dict[tuple[str, str], dedup.FileMeta] = {}
        self.logical_bytes = 0

    # ------------------------------------------------------------------
    def _container_key(self, container: int) -> bytes:
        return b"RADM" + container.to_bytes(8, "big")

    def _seal_open_container(self) -> None:
        if not self._open_entries:
            return
        container = self._next_container
        self._next_container += 1
        buf = bytes(self._open_buf).ljust(self.container_size, b"\x00")
        pieces = self.code.encode_bytes(buf)
        cluster = max(self.clusters, key=lambda c: c.free)
        cluster.store_chunk(self._container_key(container), pieces)
        self._container_cluster[container] = cluster.cluster_id
        for cid, _off, _ln in self._open_entries:
            self._chunks[cid].container = container
        self._open_buf = bytearray()
        self._open_entries = []

    def _add_chunk(self, cid: bytes, data: bytes) -> None:
        if len(self._open_buf) + len(data) > self.container_size:
            self._seal_open_container()
        off = len(self._open_buf)
        self._open_buf += data
        self._chunks[cid] = _ChunkLoc(container=-1, offset=off,
                                      length=len(data))
        self._open_entries.append((cid, off, len(data)))

    # ------------------------------------------------------------------
    def put_file(self, user: str, filename: str, data: bytes,
                 timestamp: float = 0.0) -> UploadStats:
        key = (user, filename)
        if key in self.files:
            self.delete_file(user, filename)
        spans = self.chunker.chunk_spans(data)
        view = memoryview(data)
        chunks = [bytes(view[o:o + l]) for o, l in spans]
        ids = [self.hash_fn(c) for c in chunks]
        unique_ids, _ = dedup.dedup_file(ids)
        by_id: dict[bytes, bytes] = {}
        for cid, chunk in zip(ids, chunks):
            by_id.setdefault(cid, chunk)

        new = [cid for cid in unique_ids if cid not in self._chunks]
        for cid in new:
            self._add_chunk(cid, by_id[cid])
        for cid in unique_ids:
            self._chunks[cid].refcount += 1

        meta = dedup.FileMeta(timestamp=timestamp,
                              entries=[(cid, 0) for cid in ids],
                              lengths=[l for _, l in spans])
        self.files[key] = meta
        self.logical_bytes += len(data)
        up = sum(len(by_id[cid]) for cid in new)
        return UploadStats(filename=filename, file_bytes=len(data),
                           n_chunks=len(chunks),
                           n_unique_in_file=len(unique_ids),
                           n_new_chunks=len(new), bytes_uploaded=up,
                           piece_bytes_written=0)

    # ------------------------------------------------------------------
    def _read_chunk(self, cid: bytes) -> bytes:
        loc = self._chunks[cid]
        if loc.container < 0:  # still in the open container buffer
            return bytes(self._open_buf[loc.offset:loc.offset + loc.length])
        cluster = self.clusters[self._container_cluster[loc.container]]
        key = self._container_key(loc.container)
        L = self.code.piece_len(self.container_size)
        lo_piece, hi_piece = loc.offset // L, (loc.offset + loc.length - 1) // L
        systematic: dict[int, bytes] = {}
        for p in range(lo_piece, hi_piece + 1):
            node = cluster.nodes[p]
            if node.has(key, p):
                systematic[p] = node.get(key, p)
        if len(systematic) == hi_piece - lo_piece + 1:
            blob = b"".join(systematic[p] for p in range(lo_piece, hi_piece + 1))
            off = loc.offset - lo_piece * L
            return blob[off:off + loc.length]
        # degraded read: decode the whole container from any k pieces
        pieces = cluster.read_pieces(key, self.k)
        container = self.code.decode_bytes(pieces, self.container_size)
        return container[loc.offset:loc.offset + loc.length]

    def get_file(self, user: str, filename: str,
                 local_chunk_ids: set[bytes] | None = None,
                 rho_fn=None) -> tuple[bytes, RetrievalStats]:
        meta = self.files[(user, filename)]
        local = local_chunk_ids or set()
        need: list[bytes] = []
        seen: set[bytes] = set()
        for cid, _ in meta.entries:
            if cid not in local and cid not in seen:
                need.append(cid)
                seen.add(cid)

        decoded = {cid: self._read_chunk(cid) for cid in need}
        out = bytearray()
        for (cid, _), ln in zip(meta.entries, meta.lengths):
            blob = decoded.get(cid)
            if blob is None:
                blob = self._read_chunk(cid)
            out += blob[:ln]

        t, nodes_touched, bytes_fetched = self._retrieval_time(need, rho_fn)
        stats = RetrievalStats(filename=filename, file_bytes=meta.size,
                               time_s=t, n_chunks=len(meta.entries),
                               n_fetched=len(need),
                               bytes_fetched=bytes_fetched,
                               clusters_touched=nodes_touched)
        return bytes(out), stats

    def _retrieval_time(self, need: list[bytes], rho_fn) -> tuple[float, int, int]:
        """Max-over-required-nodes fluid model (no k-of-n race).

        Chunks of one file are usually contiguous inside their container
        (packed at insertion), so per node we merge the stripe-aligned
        byte ranges before charging I/O -- alignment amortizes across
        adjacent chunks, as in the original system.
        """
        p = self.latency
        ranges: dict[tuple[int, int], list[tuple[int, int]]] = {}
        L = self.code.piece_len(self.container_size)
        su = self.stripe_unit
        for cid in need:
            loc = self._chunks[cid]
            if loc.container < 0:
                continue
            cl = self._container_cluster[loc.container]
            lo_p, hi_p = loc.offset // L, (loc.offset + loc.length - 1) // L
            span = loc.length
            off = loc.offset
            for piece in range(lo_p, hi_p + 1):
                take = min(span, L - off % L)
                lo = (off % L) // su * su
                hi = min(L, -(-(off % L + take) // su) * su)
                ranges.setdefault((cl, piece), []).append((lo, hi))
                span -= take
                off += take
        per_node: dict[tuple[int, int], int] = {}
        for key, rs in ranges.items():
            rs.sort()
            total, cur_lo, cur_hi = 0, *rs[0]
            for lo, hi in rs[1:]:
                if lo <= cur_hi:
                    cur_hi = max(cur_hi, hi)
                else:
                    total += cur_hi - cur_lo
                    cur_lo, cur_hi = lo, hi
            per_node[key] = total + (cur_hi - cur_lo)
        if not per_node:
            return p.meta_rtt, 0, 0
        # archival access pattern: redundancy groups (clusters) are read
        # one after the other (object-granular client); within a group the
        # read waits for *every* node holding needed stripes -- max, not
        # the k-of-n race SEARS gets
        per_ct: dict[tuple[int, int], dict[int, int]] = {}
        for (cl, piece), nbytes in per_node.items():
            grp = per_ct.setdefault((cl, 0), {})
            grp[piece] = grp.get(piece, 0) + nbytes
        t = 0.0
        clusters_touched = set()
        for (cl, _), nodes in per_ct.items():
            clusters_touched.add(cl)
            fair = p.client_bw / max(1, len(nodes))
            t_ct = 0.0
            for piece, nbytes in nodes.items():
                x = float(self.rng.lognormal(0.0, p.sigma))
                rho = 0.0 if rho_fn is None else min(max(rho_fn(cl), 0.0),
                                                     0.95)
                rate = min(p.conn_bw * x * (1.0 - rho), fair)
                t_ct = max(t_ct, p.rtt + nbytes / rate)
            t += t_ct  # serialized container/cluster stages
        t_search = (p.meta_rtt + p.rtt) * max(0, len(clusters_touched) - 1)
        return (p.meta_rtt + t_search + t, len(per_node),
                sum(per_node.values()))

    # ------------------------------------------------------------------
    def delete_file(self, user: str, filename: str) -> None:
        meta = self.files.pop((user, filename))
        self.logical_bytes -= meta.size
        seen: set[bytes] = set()
        for cid, _ in meta.entries:
            if cid not in seen:
                seen.add(cid)
                self._chunks[cid].refcount -= 1
        # NOTE: container GC requires compaction (out of scope, as in the
        # original R-ADMAD); dead chunks keep their container space.

    def stats(self) -> StoreStats:
        piece_bytes = sum(c.used for c in self.clusters)
        # the open container is replicated at the packing node until sealed
        piece_bytes += len(self._open_buf)
        index_bytes = (CHUNK_RECORD_BYTES * len(self._chunks)
                       + CONTAINER_RECORD_BYTES * len(self._container_cluster)
                       + sum(m.meta_bytes for m in self.files.values()))
        return StoreStats(logical_bytes=self.logical_bytes,
                          piece_bytes=piece_bytes, index_bytes=index_bytes,
                          n_unique_chunks=len(self._chunks),
                          n_files=len(self.files))

    def flush(self) -> None:
        self._seal_open_container()
