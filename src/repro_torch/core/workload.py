"""Synthetic workload mirroring the paper's evaluation dataset (S IV).

The paper's trace: 10 users over 21 days -- (1) 1.6 TB user personal data,
(2) 132 GB hourly system logs, (3) 3.5 TB daily system backup images.  We
synthesize the same *redundancy structure* at a configurable scale (default
~1/20000) because dedup ratios and the k/n curve shapes depend on the
structure, not on absolute volume (DESIGN.md S8):

* personal files: lognormal sizes; content is a mix of user-private blocks,
  a cross-user shared pool (inter-user redundancy for CLB to win on), and
  edited re-uploads of the user's earlier files (intra-user redundancy
  that both ULB and CLB capture).
* system logs: append-mostly -- each hour's file is the previous plus new
  tail, rotated daily.
* backup images: one large file per user per day, ~97% identical
  day-over-day with in-place edits.

Every event also carries the hour-of-day so Fig 3(d)'s diurnal load replay
works: requests follow the paper's day-shape (light 0:00-8:00, heavy and
fluctuating 8:00-24:00).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class FileEvent:
    day: int
    hour: int
    user: str
    filename: str
    data: bytes
    kind: str  # personal | log | backup


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_users: int = 10
    n_days: int = 21
    scale: float = 1.0 / 20000.0  # fraction of the paper's byte volume
    seed: int = 7
    # paper volumes (bytes) scaled by `scale`
    personal_total: int = int(1.6e12)
    log_total: int = int(132e9)
    backup_total: int = int(3.5e12)
    block: int = 16 << 10  # building-block granularity for shared content
    shared_fraction: float = 0.35  # of personal data drawn from shared pool
    edit_fraction: float = 0.25  # of personal files that are edits of old ones
    backup_change: float = 0.03  # day-over-day backup image churn


class _BlockPool:
    """Deterministic pool of content blocks (shared redundancy source)."""

    def __init__(self, rng: np.random.Generator, block: int, count: int):
        self.block = block
        self.count = count
        self._seeds = rng.integers(0, 2**63 - 1, size=count, dtype=np.int64)

    def get(self, idx: int) -> bytes:
        r = np.random.default_rng(int(self._seeds[idx % self.count]))
        return r.integers(0, 256, size=self.block, dtype=np.int64).astype(
            np.uint8).tobytes()


def _diurnal_hours(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sample hours with the paper's day-shape (light overnight)."""
    w = np.array([0.2] * 8 + [1.0, 1.4, 1.6, 1.5, 1.2, 1.4, 1.6, 1.7,
                              1.5, 1.3, 1.0, 0.8, 0.7, 0.5, 0.4, 0.3])
    w = w / w.sum()
    return rng.choice(24, size=n, p=w)


def generate_events(cfg: WorkloadConfig) -> Iterator[FileEvent]:
    rng = np.random.default_rng(cfg.seed)
    pool = _BlockPool(rng, cfg.block, count=4096)
    users = [f"user{u}" for u in range(cfg.n_users)]

    # -- per-user state ---------------------------------------------------
    history: dict[str, list[tuple[str, int]]] = {u: [] for u in users}
    backup_state: dict[str, np.ndarray] = {}
    log_state: dict[str, bytearray] = {u: bytearray() for u in users}

    personal_per_day = int(cfg.personal_total * cfg.scale) // cfg.n_days
    log_per_hour = max(256, int(cfg.log_total * cfg.scale) //
                       (cfg.n_days * 24 * cfg.n_users))
    backup_size = max(4096, int(cfg.backup_total * cfg.scale) //
                      (cfg.n_days * cfg.n_users))

    file_counter = 0
    for day in range(cfg.n_days):
        # ---------------- personal data ----------------
        produced = 0
        while produced < personal_per_day:
            user = users[int(rng.integers(cfg.n_users))]
            hour = int(_diurnal_hours(rng, 1)[0])
            size = int(np.clip(rng.lognormal(np.log(96e3), 1.2), 8e3, 4e6))
            if history[user] and rng.random() < cfg.edit_fraction:
                # edited re-upload of an earlier file: regenerate + mutate
                src_name, src_seed = history[user][
                    int(rng.integers(len(history[user])))]
                data = bytearray(_personal_bytes(src_seed, size, pool, cfg))
                n_edits = max(1, size // (64 << 10))
                for _ in range(n_edits):
                    off = int(rng.integers(0, max(1, len(data) - 256)))
                    data[off:off + 256] = rng.integers(
                        0, 256, 256, dtype=np.int64).astype(np.uint8).tobytes()
                name = f"{src_name}.v{day}"
                blob = bytes(data)
            else:
                seed = int(rng.integers(2**62))
                blob = _personal_bytes(seed, size, pool, cfg)
                name = f"p{file_counter}"
                history[user].append((name, seed))
            file_counter += 1
            produced += len(blob)
            yield FileEvent(day, hour, user, f"personal/{name}", blob,
                            "personal")
        # ---------------- system logs (hourly) ----------------
        for user in users:
            for hour in range(24):
                tail = np.random.default_rng(
                    cfg.seed * 1000003 + day * 24 + hour).integers(
                        0, 256, size=log_per_hour, dtype=np.int64
                    ).astype(np.uint8).tobytes()
                log_state[user] += tail
                yield FileEvent(day, hour, user,
                                f"var/log/syslog.{day}", bytes(log_state[user]),
                                "log")
            if (day + 1) % 1 == 0:
                log_state[user] = bytearray()  # daily rotation
        # ---------------- backup images (daily) ----------------
        for user in users:
            img = backup_state.get(user)
            r = np.random.default_rng(cfg.seed * 7919 + hash(user) % 1000 + day)
            if img is None:
                img = r.integers(0, 256, size=backup_size,
                                 dtype=np.int64).astype(np.uint8)
            else:
                img = img.copy()
                n_edit_bytes = int(len(img) * cfg.backup_change)
                n_spots = max(1, n_edit_bytes // 4096)
                for _ in range(n_spots):
                    off = int(r.integers(0, max(1, len(img) - 4096)))
                    img[off:off + 4096] = r.integers(0, 256, 4096,
                                                     dtype=np.int64).astype(np.uint8)
            backup_state[user] = img
            yield FileEvent(day, 3, user, f"backup/image.day{day}",
                            img.tobytes(), "backup")


def _mixed_bytes(seed: int, size: int, pool: _BlockPool,
                 shared_fraction: float, block: int) -> bytes:
    """Deterministic file content: shared-pool + private random blocks."""
    r = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < size:
        if r.random() < shared_fraction:
            out += pool.get(int(r.integers(pool.count)))
        else:
            out += r.integers(0, 256, size=block,
                              dtype=np.int64).astype(np.uint8).tobytes()
    return bytes(out[:size])


def _personal_bytes(seed: int, size: int, pool: _BlockPool,
                    cfg: WorkloadConfig) -> bytes:
    """Deterministic personal-file content: shared-pool + private blocks."""
    return _mixed_bytes(seed, size, pool, cfg.shared_fraction, cfg.block)


@dataclasses.dataclass(frozen=True)
class MultiUserConfig:
    """Trace shape for the cross-user batch scheduler (switching node).

    Many users upload concurrently; a configurable fraction of each
    user's content comes from a shared block pool, so coalesced windows
    carry the inter-user redundancy the scheduler's shared dedup/coding
    batches are built to exploit.
    """

    n_users: int = 8
    files_per_user: int = 4
    file_kb: int = 48
    shared_fraction: float = 0.4  # of each file drawn from the shared pool
    block: int = 8 << 10
    seed: int = 23


def multi_user_put_trace(cfg: MultiUserConfig
                         ) -> list[tuple[str, list[tuple[str, bytes]]]]:
    """Per-user upload batches: one (user, files) put request each.

    Deterministic in ``cfg.seed``.  Files mix user-private bytes with
    blocks from a cross-user shared pool, mirroring the paper workload's
    inter-user redundancy at request granularity.
    """
    rng = np.random.default_rng(cfg.seed)
    pool = _BlockPool(rng, cfg.block, count=256)
    trace: list[tuple[str, list[tuple[str, bytes]]]] = []
    for u in range(cfg.n_users):
        files: list[tuple[str, bytes]] = []
        for f in range(cfg.files_per_user):
            blob = _mixed_bytes(cfg.seed * 1_000_003 + u * 997 + f,
                                cfg.file_kb << 10, pool,
                                cfg.shared_fraction, cfg.block)
            files.append((f"u{u}/f{f}", blob))
        trace.append((f"user{u}", files))
    return trace


def multi_user_get_trace(put_trace: list[tuple[str, list[tuple[str, bytes]]]]
                         ) -> list[tuple[str, list[str]]]:
    """Matching retrieval requests: every user re-fetches its own files."""
    return [(user, [fn for fn, _ in files]) for user, files in put_trace]


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Trace shape for the double-buffered multi-window ingest pipeline.

    A steady stream of put windows -- each one flush-window's worth of
    per-user batches -- arriving back to back, the workload
    ``SEARSStore.put_windows_pipelined`` overlaps: window *i+1*'s device
    chunking pass runs under window *i*'s host phases.  A shared block
    pool spans all windows so later windows dedup against earlier ones
    (cross-window redundancy), exactly like a long-running switching
    node's traffic.
    """

    n_windows: int = 6
    users_per_window: int = 2
    files_per_user: int = 3
    file_kb: int = 64
    shared_fraction: float = 0.3
    block: int = 8 << 10
    seed: int = 47


def streaming_window_trace(cfg: StreamingConfig
                           ) -> Iterator[list[tuple[str,
                                                    list[tuple[str, bytes]]]]]:
    """Lazily yield put windows of (user, files) batches.

    Deterministic in ``cfg.seed`` -- every (window, user, file) triple
    derives its own content seed -- and a generator on purpose: the
    pipelined ingest path consumes windows as a stream, materializing at
    most two (the one finishing and the one whose chunk pass is in
    flight).
    """
    rng = np.random.default_rng(cfg.seed)
    pool = _BlockPool(rng, cfg.block, count=256)
    for w in range(cfg.n_windows):
        window: list[tuple[str, list[tuple[str, bytes]]]] = []
        for u in range(cfg.users_per_window):
            files = [(f"w{w}/u{u}/f{f}",
                      _mixed_bytes(cfg.seed * 2_000_003
                                   + w * 10_007 + u * 997 + f,
                                   cfg.file_kb << 10, pool,
                                   cfg.shared_fraction, cfg.block))
                     for f in range(cfg.files_per_user)]
            window.append((f"user{u}", files))
        yield window


@dataclasses.dataclass(frozen=True)
class MixedClassConfig:
    """Trace shape for mixed real-time/archival traffic (storage classes).

    Each user submits one *interactive* batch (many small hot files, the
    real-time class) and one *cold* batch (few large backup-style blobs
    with heavy day-over-day redundancy, the archival class), so a single
    scheduler flush window carries both policies at once -- the workload
    the per-class launch bucketing must amortize.
    """

    n_users: int = 4
    hot_files_per_user: int = 3
    hot_kb: int = 24
    cold_files_per_user: int = 2
    cold_kb: int = 96
    cold_churn: float = 0.05  # fraction of a cold blob rewritten per file
    shared_fraction: float = 0.35
    block: int = 8 << 10
    seed: int = 31


def mixed_class_trace(cfg: MixedClassConfig
                      ) -> list[tuple[str, list[tuple[str, bytes]], str]]:
    """Per-user (user, files, storage_class) request trace.

    Deterministic in ``cfg.seed``.  Hot files mix private and shared-pool
    blocks (dedup *within* the real-time pool); cold files are per-user
    backup images that change only ``cold_churn`` of their bytes file to
    file (heavy redundancy for the archival pool's global-dedup CLB
    binding to exploit).  Request order interleaves classes so any flush
    window over the trace is mixed.
    """
    rng = np.random.default_rng(cfg.seed)
    pool = _BlockPool(rng, cfg.block, count=256)
    trace: list[tuple[str, list[tuple[str, bytes]], str]] = []
    for u in range(cfg.n_users):
        user = f"user{u}"
        hot = [(f"u{u}/hot{f}",
                _mixed_bytes(cfg.seed * 7_919 + u * 1_009 + f,
                             cfg.hot_kb << 10, pool,
                             cfg.shared_fraction, cfg.block))
               for f in range(cfg.hot_files_per_user)]
        trace.append((user, hot, "realtime"))
        r = np.random.default_rng(cfg.seed * 104_729 + u)
        img = r.integers(0, 256, size=cfg.cold_kb << 10,
                         dtype=np.int64).astype(np.uint8)
        cold = []
        for f in range(cfg.cold_files_per_user):
            if f:
                img = img.copy()
                n_edit = max(1, int(img.size * cfg.cold_churn) // 2048)
                for _ in range(n_edit):
                    off = int(r.integers(0, max(1, img.size - 2048)))
                    img[off:off + 2048] = r.integers(
                        0, 256, 2048, dtype=np.int64).astype(np.uint8)
            cold.append((f"u{u}/cold{f}", img.tobytes()))
        trace.append((user, cold, "archival"))
    return trace


@dataclasses.dataclass(frozen=True)
class ShardTraceConfig:
    """Trace shape for the N-shard-vs-1-shard differential harness.

    Many users issue interleaved put/get/overwrite/delete ops whose
    content draws on a cross-user shared pool, so dedup hits routinely
    cross user (and therefore control-shard) boundaries -- the traffic
    that would expose any shard-count dependence in dedup, binding, or
    placement.  ``add_shard_at``/``drain_shard_at`` splice shard
    lifecycle ops into the stream at fixed positions; the differential
    replays them only against the sharded store and still demands
    byte-identical artifacts.
    """

    n_users: int = 6
    n_ops: int = 24
    files_per_put: int = 2
    file_kb: int = 32
    overwrite_fraction: float = 0.3  # of puts that rewrite a live file
    shared_fraction: float = 0.4  # of file bytes from the shared pool
    block: int = 8 << 10
    seed: int = 61
    add_shard_at: int = -1  # op position to bring a shard online (-1: never)
    drain_shard_at: int = -1  # op position to drain a live shard (-1: never)


def multi_shard_trace(cfg: ShardTraceConfig) -> list[tuple]:
    """Deterministic mixed-op trace for the shard differential.

    Returns ops in replay order:

    * ``("put", user, [(filename, blob), ...])``
    * ``("get", user, [filename, ...])``
    * ``("delete", user, filename)``
    * ``("add_shard",)`` -- bring one fresh shard online
    * ``("drain_shard", rank)`` -- drain the ``rank``-th live shard
      (by sorted shard id) at replay time

    Lifecycle ops are *advisory*: replaying against a 1-shard baseline
    skips them, and the differential proof is that skipping vs applying
    them changes nothing observable.
    """
    rng = np.random.default_rng(cfg.seed)
    pool = _BlockPool(rng, cfg.block, count=256)
    users = [f"user{u}" for u in range(cfg.n_users)]
    live: dict[str, list[str]] = {u: [] for u in users}
    file_counter = 0
    ops: list[tuple] = []
    for _ in range(cfg.n_ops):
        user = users[int(rng.integers(cfg.n_users))]
        roll = rng.random()
        if roll < 0.5 or not live[user]:
            files: list[tuple[str, bytes]] = []
            batch_names: set[str] = set()
            for _f in range(cfg.files_per_put):
                name = ""
                if live[user] and rng.random() < cfg.overwrite_fraction:
                    name = live[user][int(rng.integers(len(live[user])))]
                if not name or name in batch_names:
                    name = f"{user}/f{file_counter}"
                    live[user].append(name)
                batch_names.add(name)
                file_counter += 1
                blob = _mixed_bytes(cfg.seed * 3_000_017 + file_counter,
                                    cfg.file_kb << 10, pool,
                                    cfg.shared_fraction, cfg.block)
                files.append((name, blob))
            ops.append(("put", user, files))
        elif roll < 0.85:
            n_get = min(len(live[user]), 2)
            picks = rng.choice(len(live[user]), size=n_get, replace=False)
            ops.append(("get", user, [live[user][int(j)] for j in
                                      sorted(int(j) for j in picks)]))
        else:
            victim = live[user].pop(int(rng.integers(len(live[user]))))
            ops.append(("delete", user, victim))
    out: list[tuple] = []
    for i, op in enumerate(ops):
        if i == cfg.add_shard_at:
            out.append(("add_shard",))
        if i == cfg.drain_shard_at:
            out.append(("drain_shard", 0))
        out.append(op)
    return out


@dataclasses.dataclass(frozen=True)
class StormConfig:
    """Shape of a seeded failure storm over an (n, k) multi-cluster store.

    Each step is one storm wave: simultaneous node kills across
    ``storm_clusters`` clusters, then probabilistic revives (node back up
    with its pieces intact) or replacements (factory-fresh node: alive but
    empty -- its pieces must be rebuilt), then -- when
    ``repair_every_step`` -- a repair pass.

    With ``allow_data_loss=False`` the generator caps each cluster's
    *lost pieces* (dead nodes plus not-yet-repaired replacements) at
    ``n - k``, so every chunk keeps >= k surviving pieces at every moment
    of the trace and the whole store stays provably recoverable.  With
    ``allow_data_loss=True`` the caps come off and storms may push chunks
    past the code's tolerance -- the harness for exercising the
    ``RepairReport.unrecoverable`` path.

    **Disaster extensions** (all off by default, so existing traces are
    bit-identical):

    * ``cluster_losses`` schedules that many whole-cluster disasters,
      spread over the trace: the victim cluster is declared lost (all
      pieces gone) and -- when ``admit_after_loss`` -- a fresh cluster is
      admitted to its pool first, so placement capacity survives.  Lost
      clusters drop out of every later wave.  Note the per-cluster safe
      cap cannot protect a lost cluster's chunks; in safe mode the
      *workload* must provide >= k cross-cluster surviving pieces (e.g.
      duplicate ULB copies) for the trace to stay recoverable -- that is
      exactly the property the disaster differentials prove.
    * ``racks``/``rack_storm_prob`` add correlated shared-rack waves:
      with probability ``rack_storm_prob`` per step one cluster loses
      (up to the safe cap) every node of one rack at once (nodes are
      striped ``node_id % racks``), emitted as an ordinary correlated
      ``kill`` event.
    """

    n_clusters: int = 4
    n: int = 10
    k: int = 5
    n_steps: int = 4
    storm_clusters: int = 2  # clusters hit per storm wave
    kills_per_storm: int = 2  # node kills per hit cluster (capped when safe)
    revive_prob: float = 0.6  # per-cluster chance of a revive wave per step
    replace_fraction: float = 0.5  # revived nodes that come back wiped
    repair_every_step: bool = True
    allow_data_loss: bool = False
    seed: int = 0
    cluster_losses: int = 0  # whole-cluster disasters over the trace
    admit_after_loss: bool = True  # admit fresh capacity before each loss
    racks: int = 0  # shared racks per cluster (0: no rack correlation)
    rack_storm_prob: float = 0.0  # per-step chance of a rack wave


@dataclasses.dataclass(frozen=True)
class StormEvent:
    """One step of a failure-storm trace.

    ``kind`` is ``kill`` (nodes go down, pieces intact), ``revive``
    (nodes return with pieces intact), ``replace`` (nodes return
    factory-fresh and empty), ``repair`` (run a full prioritized repair
    pass), ``cluster_loss`` (whole-cluster disaster:
    ``store.declare_cluster_lost``), or ``admit`` (bring a fresh cluster
    online in pool/class ``pool`` -- empty means the default class).
    Kill events sharing a ``step`` are one storm wave.
    """

    step: int
    kind: str  # kill | revive | replace | repair | cluster_loss | admit
    cluster_id: int = -1
    node_ids: tuple[int, ...] = ()
    pool: str = ""  # admit events: storage-class name ("" -> default)


def failure_storm_trace(cfg: StormConfig) -> list[StormEvent]:
    """Deterministic kill/revive/replace/repair schedule for ``cfg.seed``.

    Tracks each cluster's *lost* set (dead nodes plus unrepaired
    replacements); in safe mode kills are capped so ``len(lost) <= n-k``
    always holds, which guarantees >= k surviving pieces per chunk
    throughout the trace.  A ``repair`` event rebuilds replacement nodes'
    pieces, emptying the wiped set.
    """
    if not cfg.allow_data_loss and cfg.n - cfg.k < 1:
        raise ValueError("safe storms need n > k (some loss tolerance)")
    rng = np.random.default_rng(cfg.seed)
    # per-cluster node state; a node's *pieces* are lost while it is in
    # any of these sets except plain `dead` revivals (kills keep pieces):
    dead: dict[int, set[int]] = {c: set() for c in range(cfg.n_clusters)}
    wiped: dict[int, set[int]] = {c: set() for c in range(cfg.n_clusters)}
    # down AND empty: a replacement that was killed before any repair
    # rebuilt it -- reviving it brings back an empty node, not pieces
    dead_wiped: dict[int, set[int]] = {c: set()
                                       for c in range(cfg.n_clusters)}
    lost: set[int] = set()  # whole clusters declared lost (out of play)
    loss_steps: dict[int, int] = {}
    for j in range(cfg.cluster_losses):
        s = (j * cfg.n_steps) // max(1, cfg.cluster_losses)
        loss_steps[s] = loss_steps.get(s, 0) + 1
    events: list[StormEvent] = []
    for step in range(cfg.n_steps):
        # -- whole-cluster disasters --------------------------------------
        for _ in range(loss_steps.get(step, 0)):
            candidates = sorted(set(range(cfg.n_clusters)) - lost)
            if len(candidates) <= 1:
                break  # never lose the last original cluster
            victim = int(rng.choice(candidates))
            if cfg.admit_after_loss:
                # replacement capacity comes online *before* the loss so
                # the pool never empties and re-placement has a target
                events.append(StormEvent(step, "admit"))
            events.append(StormEvent(step, "cluster_loss", victim))
            lost.add(victim)
            dead[victim].clear()
            wiped[victim].clear()
            dead_wiped[victim].clear()
        alive_clusters = sorted(set(range(cfg.n_clusters)) - lost)
        # -- storm wave: simultaneous kills across several clusters ------
        hit = rng.choice(alive_clusters,
                         size=min(cfg.storm_clusters, len(alive_clusters)),
                         replace=False)
        for c in sorted(int(c) for c in hit):
            down = dead[c] | dead_wiped[c]
            alive = sorted(set(range(cfg.n)) - down)
            cap = len(alive)
            if not cfg.allow_data_loss:
                cap = (cfg.n - cfg.k) - len(down | wiped[c])
            n_kill = min(cfg.kills_per_storm, cap, len(alive))
            if n_kill <= 0:
                continue
            ids = {int(i) for i in rng.choice(alive, size=n_kill,
                                              replace=False)}
            dead[c] |= ids - wiped[c]
            dead_wiped[c] |= ids & wiped[c]  # killed replacement: empty
            wiped[c] -= ids
            events.append(StormEvent(step, "kill", c, tuple(sorted(ids))))
        # -- recovery wave: some down nodes come back ---------------------
        for c in range(cfg.n_clusters):
            down = sorted(dead[c] | dead_wiped[c])
            if not down or rng.random() >= cfg.revive_prob:
                continue
            n_back = int(rng.integers(1, len(down) + 1))
            back = [int(i) for i in rng.choice(down, size=n_back,
                                               replace=False)]
            revived = [i for i in back
                       if rng.random() >= cfg.replace_fraction]
            replaced = [i for i in back if i not in revived]
            if revived:
                # a revived ex-replacement comes back *empty* (its pieces
                # were already gone) -- it stays in the lost set as wiped
                wiped[c] |= set(revived) & dead_wiped[c]
                dead[c] -= set(revived)
                dead_wiped[c] -= set(revived)
                events.append(StormEvent(step, "revive", c,
                                         tuple(sorted(revived))))
            if replaced:  # alive but empty: still lost until repaired
                dead[c] -= set(replaced)
                dead_wiped[c] -= set(replaced)
                wiped[c] |= set(replaced)
                events.append(StormEvent(step, "replace", c,
                                         tuple(sorted(replaced))))
        # -- correlated rack wave: one rack of one cluster at once --------
        if cfg.racks > 0 and cfg.rack_storm_prob > 0 and alive_clusters \
                and rng.random() < cfg.rack_storm_prob:
            c = int(rng.choice(alive_clusters))
            rack = int(rng.integers(cfg.racks))
            down = dead[c] | dead_wiped[c]
            alive = sorted(set(range(cfg.n)) - down)
            ids = [i for i in alive if i % cfg.racks == rack]
            if not cfg.allow_data_loss:
                cap = (cfg.n - cfg.k) - len(down | wiped[c])
                ids = ids[:max(0, cap)]
            if ids:
                ids_set = set(ids)
                dead[c] |= ids_set - wiped[c]
                dead_wiped[c] |= ids_set & wiped[c]
                wiped[c] -= ids_set
                events.append(StormEvent(step, "kill", c,
                                         tuple(sorted(ids_set))))
        # -- repair pass: rebuilds pieces on alive nodes ------------------
        if cfg.repair_every_step:
            events.append(StormEvent(step, "repair"))
            for c in range(cfg.n_clusters):
                wiped[c].clear()  # replacements healed (>= k survivors)
    return events


def apply_storm(store, events: list[StormEvent]) -> list:
    """Replay a failure-storm trace against a live store.

    ``kill``/``revive``/``replace`` mutate the cluster nodes;
    ``cluster_loss``/``admit`` run the store's disaster lifecycle
    (``declare_cluster_lost`` queues the victim's chunks for
    cross-cluster re-placement; ``admit`` brings a fresh cluster online
    in the event's class, default class when empty); each ``repair``
    event runs a full prioritized ``store.repair.repair()`` pass.
    Returns the ``RepairReport`` of every repair event in trace order.
    """
    reports = []
    for ev in events:
        if ev.kind == "kill":
            store.clusters[ev.cluster_id].kill_nodes(list(ev.node_ids))
        elif ev.kind == "revive":
            store.clusters[ev.cluster_id].revive_nodes(list(ev.node_ids))
        elif ev.kind == "replace":
            store.clusters[ev.cluster_id].replace_nodes(list(ev.node_ids))
        elif ev.kind == "cluster_loss":
            store.declare_cluster_lost(ev.cluster_id)
        elif ev.kind == "admit":
            store.admit_cluster(storage_class=ev.pool or None)
        elif ev.kind == "repair":
            reports.append(store.repair.repair())
        else:
            raise ValueError(f"unknown storm event kind {ev.kind!r}")
    return reports


@dataclasses.dataclass(frozen=True)
class SLOTraceConfig:
    """Closed-loop zipf trace for the block-cache / SLO benchmark.

    Models a million-user switching node front end: user identities are
    drawn zipf-ranked from an ``n_users``-sized id space (a handful of
    heavy hitters dominate, the long tail appears once), and every
    operation touches one file of a small shared **hot catalog** whose
    contents are identical across users -- the canonical
    popular-object workload (software updates, viral media).  Under a
    pool-scoped-dedup CLB class each catalog file's chunks are stored
    exactly once system-wide, so repeated access from *different* users
    converges on the same chunk copies: precisely the traffic a
    switching-node block cache exists to absorb.

    The trace is closed-loop: the first time a (user, file) pair
    appears it is a put, every later appearance is a get -- each user
    must upload before it can fetch, and the hot files accumulate gets.
    """

    n_users: int = 1_000_000  # zipf-ranked user-id space
    n_ops: int = 200
    catalog_files: int = 32  # shared hot-catalog size
    file_kb: int = 24
    zipf_a: float = 1.2  # skew of both the user and the file popularity
    storage_class: str | None = "archival"  # class the bench replays under
    seed: int = 83


def zipf_slo_trace(cfg: SLOTraceConfig) -> list[tuple]:
    """Deterministic (put|get, user, payload) ops, multi_shard_trace style.

    * ``("put", user, [(filename, blob)])`` -- first touch of a
      (user, catalog file) pair
    * ``("get", user, [filename])`` -- every repeat touch

    Catalog file ``j``'s bytes depend only on ``(seed, j)``, never on
    the user, so cross-user dedup (and therefore cache-hit sharing) is
    structural, not accidental.
    """
    rng = np.random.default_rng(cfg.seed)
    catalog = []
    for j in range(cfg.catalog_files):
        r = np.random.default_rng(cfg.seed * 5_000_011 + j)
        catalog.append(r.integers(0, 256, size=cfg.file_kb << 10,
                                  dtype=np.int64).astype(np.uint8).tobytes())
    seen: set[tuple[int, int]] = set()
    ops: list[tuple] = []
    for _ in range(cfg.n_ops):
        uid = (int(rng.zipf(cfg.zipf_a)) - 1) % cfg.n_users
        j = (int(rng.zipf(cfg.zipf_a)) - 1) % cfg.catalog_files
        user = f"user{uid}"
        fname = f"u{uid}/c{j}"
        if (uid, j) not in seen:
            seen.add((uid, j))
            ops.append(("put", user, [(fname, catalog[j])]))
        else:
            ops.append(("get", user, [fname]))
    return ops


def request_trace(cfg: WorkloadConfig, events: list[FileEvent],
                  requests_per_user_day: int = 6) -> list[tuple[int, int, str, str]]:
    """Replayable retrieval trace: (day, hour, user, filename).

    Mirrors the paper's replay of the personal-data access pattern: users
    re-fetch their own recent personal files with diurnal intensity.
    """
    rng = np.random.default_rng(cfg.seed + 1)
    by_user: dict[str, list[FileEvent]] = {}
    for ev in events:
        if ev.kind == "personal":
            by_user.setdefault(ev.user, []).append(ev)
    trace = []
    for day in range(cfg.n_days):
        for user, evs in by_user.items():
            avail = [e for e in evs if e.day <= day]
            if not avail:
                continue
            hours = _diurnal_hours(rng, requests_per_user_day)
            for h in hours:
                # recency-biased choice
                idx = len(avail) - 1 - int(
                    rng.exponential(max(1.0, len(avail) / 4)))
                ev = avail[int(np.clip(idx, 0, len(avail) - 1))]
                trace.append((day, int(h), user, ev.filename))
    trace.sort(key=lambda t: (t[0], t[1]))
    return trace
