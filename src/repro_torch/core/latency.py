"""EC2-calibrated retrieval-latency model (paper S IV).

The paper measures wall-clock file retrieval on EC2; this container has no
network, so we model it.  The model is an order-statistics fluid model, the
standard analysis for coded storage latency (the paper's own refs [9],[10]):

* The client opens one persistent connection per storage node of every
  cluster involved and nodes stream their code pieces back-to-back
  (pipelined requests, as any production client would).
* Connection ``i`` has rate ``r_i = min(conn_bw * X_i * (1 - rho), client_bw
  / N_active)`` -- ``X_i ~ LogNormal(0, sigma)`` is the per-path speed
  draw (slow-node tail), ``rho`` the target-cluster utilisation (queueing
  congestion, drives the Fig 3(d) CLB fluctuation), and the client NIC is
  processor-shared across all active connections.
* Each node holds 1/n of the cluster's pieces and each piece is 1/k of a
  chunk, so a connection must deliver ``cluster_bytes / k`` bytes; a chunk
  completes when the **k-th fastest** of its cluster's n connections has
  reached it -- the file's download time per cluster is the k-th order
  statistic of ``rtt + bytes_conn / r_i`` and the file completes at the max
  over involved clusters (CLB fans out, ULB involves exactly one).
* GF(256) decode costs ``k`` multiply-XORs per output byte; decode is
  pipelined behind the download and only the residual tail adds latency.
  (If the k systematic pieces arrive first decode is skipped; with random
  node speeds that has probability 1/C(n,k), which we ignore.)

``calibrate()`` fixes the free constants against the paper's two anchors:
3 MB single-stream EC2 download = 7 s, and ULB(10,5) = 2.5 s.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    rtt: float = 0.08  # s, per-request base latency (US-East desktop<->EC2)
    conn_bw: float = 0.45e6  # B/s single-connection streaming throughput
    client_bw: float = 3.0e6  # B/s client NIC / last-mile cap
    sigma: float = 0.45  # lognormal spread of per-path speeds
    decode_rate: float = 45e6  # GF(256) multiply-XOR bytes/s per k=1
    meta_rtt: float = 0.08  # fetch file chunk-meta-data from switching node
    piece_cpu: float = 200e-6  # client-side handling per received piece
    pool: int = 24  # client's concurrent-connection budget

    def single_stream_time(self, nbytes: int, rng: np.random.Generator,
                           rho: float = 0.0) -> float:
        """Baseline: one plain connection (the EC2 comparison point)."""
        x = float(rng.lognormal(0.0, self.sigma))
        rate = min(self.conn_bw * x * max(1e-6, 1.0 - rho), self.client_bw)
        return self.rtt + nbytes / rate


class RepairBandwidth:
    """Token-bucket repair budget + per-cluster repair-traffic load model.

    Two coupled roles, shared between the scheduler's foreground windows
    and the repair/scrub lanes:

    * **Throttle** -- ``try_take(nbytes)`` draws repair bytes from a
      token bucket refilled at ``limit_bps`` (burst-capped).  The repair
      drain asks before rebuilding each chunk and defers what the budget
      refuses, so a rebuild storm trickles out at the configured rate
      instead of monopolizing the links.  ``limit_bps=None`` grants
      everything (track-only mode -- the "unthrottled" comparison point).
    * **Load model** -- ``note(cluster_id, nbytes)`` records where repair
      traffic actually went; ``rho(cluster_id)`` converts the recent
      windowed byte rate into the utilisation ``retrieval_time`` charges
      foreground connections on that cluster (``SEARSStore._assemble``
      floors each share's rho with it).  Tracking is always on once the
      object is installed, so an unthrottled drain still congests
      foreground gets -- that asymmetry is exactly what the disaster
      bench measures.

    ``clock`` is injectable (like the scheduler's auto-flush clock) so
    tests and benchmarks drive time deterministically.
    """

    def __init__(self, link_bps: float = 50e6,
                 limit_bps: float | None = None,
                 burst_bytes: float | None = None,
                 window_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if link_bps <= 0:
            raise ValueError(f"link_bps must be > 0, got {link_bps}")
        if limit_bps is not None and limit_bps <= 0:
            raise ValueError(f"limit_bps must be > 0, got {limit_bps}")
        self.link_bps = float(link_bps)
        self.limit_bps = None if limit_bps is None else float(limit_bps)
        self.burst_bytes = float(
            burst_bytes if burst_bytes is not None
            else (self.limit_bps or self.link_bps) * window_s)
        self.window_s = float(window_s)
        self._clock = clock
        self._tokens = self.burst_bytes
        self._refilled = clock()
        self._win_start = self._refilled
        self._cur: dict[int, float] = {}  # bytes this window, per cluster
        self._prev: dict[int, float] = {}  # previous full window
        self.taken = 0  # bytes granted to repair
        self.deferred = 0  # grant refusals (repair items pushed back)

    # ------------------------------------------------------ token bucket --
    def try_take(self, nbytes: int) -> bool:
        """Draw ``nbytes`` of repair budget; False defers the work."""
        if self.limit_bps is None:
            self.taken += nbytes
            return True
        now = self._clock()
        self._tokens = min(self.burst_bytes,
                           self._tokens
                           + (now - self._refilled) * self.limit_bps)
        self._refilled = now
        if self._tokens >= nbytes:
            self._tokens -= nbytes
            self.taken += nbytes
            return True
        self.deferred += 1
        return False

    # -------------------------------------------------------- load model --
    def _advance(self) -> None:
        now = self._clock()
        elapsed = now - self._win_start
        if elapsed >= self.window_s:
            # the finished window becomes history unless it is stale
            self._prev = self._cur if elapsed < 2 * self.window_s else {}
            self._cur = {}
            self._win_start = now

    def note(self, cluster_id: int, nbytes: int) -> None:
        """Record repair bytes moved to/from a cluster (always tracked)."""
        self._advance()
        self._cur[cluster_id] = self._cur.get(cluster_id, 0.0) + nbytes

    def rho(self, cluster_id: int) -> float:
        """Recent repair-traffic utilisation of one cluster, in [0, 0.95]."""
        self._advance()
        nbytes = (self._prev.get(cluster_id, 0.0)
                  + self._cur.get(cluster_id, 0.0))
        span = self.window_s + (self._clock() - self._win_start)
        return min(0.95, (nbytes / span) / self.link_bps)


def cache_hit_time(nbytes: int, params: LatencyParams) -> float:
    """Wall-clock time for a retrieval served from the block cache.

    A hit skips every cluster connection (no per-node streams, no
    order-statistic tail, no decode -- the cache holds decoded bytes):
    the client pays the switching-node round trip plus streaming the
    blob over its own NIC at full rate.  Partial hits compose: the
    cached bytes ride this path while the misses pay
    :func:`retrieval_time`; ``SEARSStore._assemble`` adds the two.
    """
    return params.meta_rtt + nbytes / params.client_bw


@dataclasses.dataclass(frozen=True)
class ClusterShare:
    """Bytes of one file stored on one cluster, with that cluster's load."""

    cluster_id: int
    nbytes: int  # original (decoded) bytes of this file on this cluster
    rho: float = 0.0  # cluster utilisation in [0, 1)


def retrieval_time(shares: list[ClusterShare], n: int, k: int,
                   params: LatencyParams, rng: np.random.Generator) -> float:
    """Simulated wall-clock retrieval time for one file."""
    if not shares or all(s.nbytes == 0 for s in shares):
        return params.meta_rtt
    shares = [s for s in shares if s.nbytes > 0]
    n_active = n * len(shares)  # total wanted connections
    # the client's connection pool bounds true concurrency: excess
    # connections time-share their slots (CLB fan-out pays here)
    overcommit = max(1.0, n_active / params.pool)
    fair_share = params.client_bw / min(n_active, params.pool)

    t_download = 0.0
    total_bytes = 0
    t_first = np.inf
    for s in shares:
        x = rng.lognormal(0.0, params.sigma, size=n)
        rho = min(max(s.rho, 0.0), 0.95)
        rates = np.minimum(params.conn_bw * x * (1.0 - rho), fair_share)
        bytes_conn = s.nbytes * overcommit / k  # time-shared slot
        finish = params.rtt + bytes_conn / rates
        # chunk completes at the k-th fastest connection; the last chunk of
        # this cluster's share completes at the k-th order statistic
        t_cluster = float(np.sort(finish)[k - 1])
        t_download = max(t_download, t_cluster)
        t_first = min(t_first, float(np.sort(params.rtt + (4096 / k) / rates)[k - 1]))
        total_bytes += s.nbytes

    # client-side costs growing with k: GF decode (k mul-XORs per output
    # byte) and per-piece handling (k pieces consumed per chunk) -- the
    # paper's stated high-k bottleneck ("the larger number of concurrent
    # retrieval processes and the decoding process ... become the
    # bottleneck").  The prototype client decodes serially after receipt,
    # so client time adds to (rather than pipelines behind) the download.
    del t_first
    n_chunks = max(1, total_bytes // 4096)
    t_client = (total_bytes * k / params.decode_rate
                + n_chunks * k * params.piece_cpu)
    t_done = t_download + t_client
    # CLB fan-out pays a chunk-location search across the involved
    # clusters' indexes plus fresh connection establishment per extra
    # cluster (paper S IV: "searching for chunks across all clusters
    # leads to the higher file retrieval time")
    t_search = (params.meta_rtt + params.rtt) * (len(shares) - 1)
    return params.meta_rtt + t_search + t_done


def expected_retrieval_time(nbytes: int, n: int, k: int,
                            params: LatencyParams,
                            rng: np.random.Generator,
                            n_clusters: int = 1,
                            rho: float = 0.0,
                            samples: int = 64) -> float:
    """Monte-Carlo mean retrieval time for a file spread over clusters."""
    per = nbytes // n_clusters
    shares = [ClusterShare(i, per, rho) for i in range(n_clusters)]
    times = [retrieval_time(shares, n, k, params, rng) for _ in range(samples)]
    return float(np.mean(times))


def calibrate(target_single: float = 7.0, target_ulb: float = 2.5,
              nbytes: int = 3 * 2**20, n: int = 10, k: int = 5,
              seed: int = 0) -> LatencyParams:
    """Fit (conn_bw, client_bw) to the paper's two anchor measurements.

    decode_rate and piece_cpu are physical constants (software GF(256)
    on 2015-era hardware), not free parameters -- the client NIC cap is
    what absorbs the residual between 10-way parallel streaming and the
    observed 2.5 s.
    """
    rng = np.random.default_rng(seed)
    del rng
    # anchor 1: single stream.  E[1/X] = exp(sigma^2/2) for lognormal.
    p0 = LatencyParams()
    inv_x = float(np.exp(p0.sigma**2 / 2.0))
    conn_bw = nbytes * inv_x / (target_single - p0.rtt)
    p1 = dataclasses.replace(p0, conn_bw=conn_bw)
    # anchor 2: solve client_bw so ULB(n,k) hits the target.
    lo, hi = 0.2e6, 50e6
    for _ in range(40):
        mid = (lo * hi) ** 0.5
        p = dataclasses.replace(p1, client_bw=mid)
        t = expected_retrieval_time(nbytes, n, k, p,
                                    np.random.default_rng(seed), samples=96)
        if t > target_ulb:
            lo = mid  # too slow -> more client bandwidth
        else:
            hi = mid
    return dataclasses.replace(p1, client_bw=(lo * hi) ** 0.5)
