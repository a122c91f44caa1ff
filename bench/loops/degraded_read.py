"""Closed-loop retrieval with nodes down: each round every user gets files.

Mix keys: ``content`` (the generator's parameters), ``stored_rounds``
(rounds put at set-up), ``read_from`` (``"all"`` stored rounds, or the
``"last"``: a backup's latest image), ``gets_per_user`` (files each user
gets a round, drawn from the seed without repeats within the round),
``kill_nodes`` (nodes taken down in every cluster after the puts,
before one untimed warm round) and ``reserve_rounds``.  Every get of
the window is compared with the bytes put, and the piece bytes its gets
read from the nodes are counted (``read_bytes_per_byte``).

Control: the reference's decode, put in the program's place with the
guarantee of exact reads broken: it skips the GF(2^8) decode and takes
the k lowest pieces that arrived as the data pieces.
"""

from __future__ import annotations

from bench.harness import checks


def setup(run) -> None:
    mix, gen = run.mix, run.gen
    stored = [gen.round() for _ in range(mix["stored_rounds"])]
    for files in stored:
        run.put_round(files)
    eligible = stored[-1:] if mix["read_from"] == "last" else stored
    run.state["data"] = {(u, fn): d for files in stored
                         for u, fn, d in files}
    run.state["names"] = {
        u: [fn for files in eligible for uu, fn, _ in files if uu == u]
        for u in gen.users()}
    for cluster in run.store.clusters:
        cluster.kill_nodes(mix["kill_nodes"])
    run.state["got"], run.state["want"] = [], []
    for gets in _rounds(run, 1):
        run.get_round(gets)
    _count_node_reads(run)


def _count_node_reads(run) -> None:
    """Count the piece bytes the window's gets read from the nodes: the
    store's one bulk read path (``_read_cluster_pieces``), wrapped on
    this store instance."""
    store = run.store
    read = store._read_cluster_pieces
    run.state["node_read_bytes"] = 0

    def counted(cluster_id, chunk_ids):
        got = read(cluster_id, chunk_ids)
        if run.timed:
            run.state["node_read_bytes"] += sum(
                len(p) for pieces in got.values() for p in pieces.values())
        return got
    store._read_cluster_pieces = counted


def _rounds(run, count: int) -> list:
    per = run.mix["gets_per_user"]
    out = []
    for _ in range(count):
        out.append([(u, [names[int(i)] for i in run.rng.choice(
            len(names), size=per, replace=False)])
            for u, names in run.state["names"].items()])
    return out


def prepare(run) -> list:
    return _rounds(run, run.mix["reserve_rounds"])


def round(run, gets) -> None:
    run.state["got"].extend(run.get_round(gets))
    run.state["want"].extend((u, fn) for u, names in gets for fn in names)


def check(run) -> dict:
    data = run.state["data"]
    return checks.check_gets(run.state["got"],
                             [data[key] for key in run.state["want"]])


def control() -> dict:
    """The engine's decode, replaced in the control run."""
    def skip_decode(jobs):
        out = []
        for code, pieces, nbytes in jobs:
            idx = sorted(pieces)[:code.k]
            out.append(b"".join(pieces[i] for i in idx)[:nbytes])
        return out
    return {"engine": {"decode_blobs_multi": skip_decode}}
