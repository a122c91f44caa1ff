"""Closed-loop uploads: each round every user puts its files, one flush.

Mix keys: ``content`` (the generator's parameters), ``setup`` with
``store_pool`` (put the shared pool once per user, so the traffic's
shared blocks find their copies from the first round), ``stored_rounds``
(rounds put before the warm round, an untimed round of the window's
shapes: a backup's generation 0), ``reserve_rounds`` (rounds made
before the window opens) and ``sample_files`` (acknowledged files the
reference re-derives; one of them is always from the last round).

Control: the program's own write-back path, which acknowledges a put at
cache commit and lands its pieces in a later, budgeted flush: the
configuration's guarantee broken.
"""

from __future__ import annotations

from bench.harness import checks


def setup(run) -> None:
    gen, s = run.gen, run.mix["setup"]
    if s.get("store_pool") and gen.c.pool_blocks:
        pool = gen.pool_file()
        run.put_round([(u, "pool", pool) for u in gen.users()])
    for _ in range(s.get("stored_rounds", 0) + 1):  # and the warm round
        run.put_round(gen.round())


def prepare(run) -> list:
    return [run.gen.round() for _ in range(run.mix["reserve_rounds"])]


def round(run, files) -> None:
    run.put_round(files)


def check(run) -> dict:
    acked = run.acked
    if not acked:
        return {}
    n = min(run.mix["sample_files"], len(acked))
    last = len(acked) - 1 - int(run.rng.integers(
        min(len(acked), run.gen.c.users * run.gen.c.files_per_user)))
    rest = [i for i in range(len(acked)) if i != last]
    pick = [last] + sorted(int(i) for i in run.rng.choice(
        rest, size=min(n - 1, len(rest)), replace=False))
    return checks.check_puts(run.store, _Class(run.cfg["class"]),
                             [acked[i] for i in pick])


class _Class:
    """The configuration's class, as the reference reads it."""

    def __init__(self, c: dict) -> None:
        self.n, self.k = c["n"], c["k"]
        self.chunk_min, self.chunk_avg, self.chunk_max = (
            c["chunk_min"], c["chunk_avg"], c["chunk_max"])


def control() -> dict:
    """The store's and the scheduler's settings of the control run."""
    from repro_torch.core.cache import CacheConfig
    # room for every dirty chunk of a run (no forced full drain), and one
    # chunk landed a flush: the rest stays dirty, acknowledged without
    # its pieces
    return {"store": {"cache": CacheConfig(capacity_bytes=1 << 40,
                                           write_back=True)},
            "scheduler": {"writeback_bytes_per_flush": 1}}
