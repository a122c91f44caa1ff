"""The comparison that decides ``correct``: the program against the reference.

Every number compared is a count of disagreements and its limit is 0.

* ``boundaries_off``: sampled files whose chunk lengths, as the store
  recorded them, differ from the reference's CDC of the bytes put;
* ``ids_off``: chunks of those files (where the boundaries agree) whose
  recorded id is not the reference's SHA-1;
* ``pieces_off``: (chunk, piece) slots of those chunks not held, as the
  reference encodes them, by node ``piece`` of the chunk's cluster while
  that node is alive: the configuration's guarantee that an acknowledged
  put has all n pieces on n distinct live nodes;
* ``gets_off``: gets whose bytes differ from the bytes put;
* ``failed``: requests of the window that did not resolve OK.
"""

from __future__ import annotations

from bench.reference import cdc, ids, rs

NAMES = ("boundaries_off", "ids_off", "pieces_off", "gets_off", "failed")


def check_puts(store, cls, sample) -> dict:
    """``sample``: (user, filename, data) of acknowledged puts."""
    out = {"boundaries_off": 0, "ids_off": 0, "pieces_off": 0}
    for user, filename, data in sample:
        meta = store.switching[user].table.get(filename)
        want = cdc.lengths(data, cls.chunk_min, cls.chunk_avg, cls.chunk_max)
        if meta is None or list(meta.lengths) != want:
            out["boundaries_off"] += 1
            continue
        chunks, pos = [], 0
        for ln in want:
            chunks.append(data[pos:pos + ln])
            pos += ln
        seen: dict[bytes, tuple[bytes, int]] = {}
        for chunk, (cid, cluster_id) in zip(chunks, meta.entries):
            if ids.chunk_id(chunk) != cid:
                out["ids_off"] += 1
                continue
            seen.setdefault(cid, (chunk, cluster_id))
        blobs = [chunk for chunk, _ in seen.values()]
        pieces = rs.encode_many(blobs, cls.n, cls.k)
        for (cid, (_, cluster_id)), want_pieces in zip(seen.items(), pieces):
            nodes = store.clusters[cluster_id].nodes
            for i, piece in enumerate(want_pieces):
                node = nodes[i] if i < len(nodes) else None
                if node is None or not node.alive or not node.has(cid, i) \
                        or node.get(cid, i) != piece:
                    out["pieces_off"] += 1
    return out


def check_gets(got, expected) -> dict:
    """``got``: bytes returned per get (None where missing); ``expected``:
    the bytes put, in the same order."""
    return {"gets_off": sum(1 for g, e in zip(got, expected) if g != e)
            + abs(len(got) - len(expected))}
