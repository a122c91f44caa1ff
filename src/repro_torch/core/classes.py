"""Storage classes: per-request policies over heterogeneous cluster pools.

The paper's pitch -- "with proper association of data to storage server
clusters, SEARS provides flexible mixing of different configurations,
suitable for real-time and archival applications" -- needs a public knob
that is *per request*, not per store.  A :class:`StorageClass` bundles
every policy axis the pipeline keys on:

* ``(n, k)`` -- the erasure code.  Low ``k`` means fewer pieces on the
  retrieval critical path (the latency knob of Kumar et al.); high ``k``
  means lower ``n/k`` redundancy overhead (the archival knob).
* chunker ``min/avg/max`` -- small chunks dedup finer-grained interactive
  edits; large chunks cut index overhead for cold bulk data.
* binding scheme -- ULB pins a user to one cluster (one connection setup
  per retrieval); CLB levels load across the class's whole pool.
* dedup scope -- ``"pool"`` keeps the class's data self-contained (its
  chunks never reference, and are never referenced from, another pool);
  ``"global"`` lets the class dedup against every cluster in the store.
* pool tag -- classes sharing a tag share one cluster pool (they must
  then agree on ``(n, k)``, since a cluster stores one piece per node).

``SEARSStore(classes=[...])`` partitions its clusters into per-class
pools; every cluster carries its own ``(n, k)`` so retrieval, deletion
and repair resolve the code from the *owning cluster*, never from a
store-wide global.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.chunking import Chunker
from repro_torch.core.rs_code import RSCode


@dataclasses.dataclass(frozen=True)
class StorageClass:
    """One named storage policy: code, chunking, binding, dedup, pool."""

    name: str
    n: int = 10
    k: int = 5
    chunk_min: int = 1024
    chunk_avg: int = 4096
    chunk_max: int = 8192
    binding: str = "ulb"
    dedup: str = "pool"  # "pool" | "global"
    pool: str = ""  # cluster-pool tag; empty -> a pool of its own (name)
    weight: float = 1.0  # share of the store's clusters for this pool
    priority: int = 1  # scheduler lane: lower runs first, sheds last

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("storage class needs a name")
        if self.dedup not in ("pool", "global"):
            raise ValueError(f"dedup scope must be 'pool' or 'global', "
                             f"got {self.dedup!r}")
        if not (0 < self.chunk_min <= self.chunk_avg <= self.chunk_max):
            raise ValueError(
                f"need 0 < min <= avg <= max chunk sizes, got "
                f"({self.chunk_min}, {self.chunk_avg}, {self.chunk_max})")
        if self.weight <= 0:
            raise ValueError(f"pool weight must be > 0, got {self.weight}")
        if self.dedup == "global" and self.binding == "ulb":
            # ULB's dedup scope is *defined* as the user's bound cluster
            # (paper S III) -- a store-wide scope cannot take effect, so
            # reject the combination instead of silently ignoring it
            raise ValueError(
                "dedup='global' is incompatible with binding='ulb' "
                "(user-level binding scopes dedup to the bound cluster)")
        self.code  # validate (n, k) early via the generator matrix

    @property
    def code(self) -> RSCode:
        return RSCode(self.n, self.k)

    @property
    def chunker(self) -> Chunker:
        return Chunker(min_size=self.chunk_min, avg_size=self.chunk_avg,
                       max_size=self.chunk_max)

    @property
    def pool_tag(self) -> str:
        return self.pool or self.name

    @property
    def storage_overhead(self) -> float:
        """Space expansion n/k of the class's code."""
        return self.n / self.k

    def spawn_cluster(self, cluster_id: int, node_capacity: int):
        """Build a fresh cluster carrying this class's pool ``(n, k)``.

        The admission half of the disaster-recovery lifecycle: after
        ``declare_lost()`` removes a cluster from a pool,
        ``SEARSStore.admit_cluster`` uses this to bring replacement
        capacity online with the pool's own code (a cluster stores one
        piece per node, so its code is fixed at birth).
        """
        from repro_torch.core.cluster import Cluster
        return Cluster(cluster_id, self.n, node_capacity, k=self.k)

    # ------------------------------------------------------------ presets --
    @classmethod
    def realtime(cls, **overrides) -> "StorageClass":
        """Interactive preset: fast retrieval over space efficiency.

        Low ``k`` keeps few pieces on the critical path, small chunks
        track fine-grained edits, and ULB gives each user one sticky
        cluster (one connection setup per retrieval, the paper's
        interactive mode).
        """
        base = dict(name="realtime", n=10, k=5, chunk_min=1024,
                    chunk_avg=4096, chunk_max=8192, binding="ulb",
                    dedup="pool", priority=0)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def archival(cls, **overrides) -> "StorageClass":
        """Cold-data preset: space efficiency over retrieval latency.

        High ``k`` drops redundancy overhead to n/k = 1.4, larger chunks
        cut per-chunk index cost, and CLB levels the pool and dedups
        across every user writing into it (the paper's archival mode).
        """
        base = dict(name="archival", n=14, k=10, chunk_min=2048,
                    chunk_avg=8192, chunk_max=16384, binding="clb",
                    dedup="pool", priority=2)
        base.update(overrides)
        return cls(**base)


def partition_pools(classes: list[StorageClass],
                    num_clusters: int) -> dict[str, tuple[int, ...]]:
    """Split ``num_clusters`` cluster ids into per-pool contiguous ranges.

    Pools are ordered by first appearance in ``classes``; each gets at
    least one cluster and otherwise a share proportional to the summed
    ``weight`` of the classes tagging it (largest-remainder rounding, so
    the partition is deterministic and exactly exhausts the clusters).
    Classes sharing a pool tag must agree on ``(n, k)`` -- a cluster
    stores one piece per node, so its code is a pool-level property.
    """
    if not classes:
        raise ValueError("need at least one storage class")
    names = [c.name for c in classes]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate storage class names in {names}")
    pools: dict[str, float] = {}
    pool_nk: dict[str, tuple[int, int]] = {}
    for c in classes:
        tag = c.pool_tag
        nk = (c.n, c.k)
        if pool_nk.setdefault(tag, nk) != nk:
            raise ValueError(
                f"classes sharing pool {tag!r} disagree on (n, k): "
                f"{pool_nk[tag]} vs {nk}")
        pools[tag] = pools.get(tag, 0.0) + c.weight
    if num_clusters < len(pools):
        raise ValueError(f"{len(pools)} cluster pools need at least "
                         f"{len(pools)} clusters, have {num_clusters}")
    total_w = sum(pools.values())
    tags = list(pools)
    # largest-remainder apportionment with a floor of one cluster per pool
    shares = {t: 1 + (num_clusters - len(tags)) * pools[t] / total_w
              for t in tags}
    counts = {t: int(shares[t]) for t in tags}
    leftover = num_clusters - sum(counts.values())
    by_remainder = sorted(tags, key=lambda t: (counts[t] - shares[t],
                                               tags.index(t)))
    for t in by_remainder[:leftover]:
        counts[t] += 1
    out: dict[str, tuple[int, ...]] = {}
    next_id = 0
    for t in tags:
        out[t] = tuple(range(next_id, next_id + counts[t]))
        next_id += counts[t]
    assert next_id == num_clusters
    return out
