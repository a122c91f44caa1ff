"""Faults planted under the timed path must turn ``correct`` false.

Each test drives a whole run on the CPU (the look for a card skipped)
with one fault switched on for the window's flushes only: a write that
leaves the store unchanged, half of a batch left out, or an answer
altered where it is produced (a piece, a chunk id, a boundary, a decoded
chunk).  No cell runs on more than one chip, so the exchange between
chips has no fault here.
"""

import pytest

from bench.harness import runner
from bench.tests import tiny


class Window:
    on = False


@pytest.fixture
def window(monkeypatch):
    flush = runner.Run.flush

    def flagged(self):
        Window.on = self.timed
        try:
            flush(self)
        finally:
            Window.on = False
    monkeypatch.setattr(runner.Run, "flush", flagged)
    return Window


def _flip(b: bytes) -> bytes:
    return b[:-1] + bytes([b[-1] ^ 0x5A]) if b else b"\x01"


class Faulty(type(tiny.engine())):
    fault = ""

    def hash_encode_blobs_multi(self, jobs):
        ids, pieces = super().hash_encode_blobs_multi(jobs)
        if Window.on and self.fault == "piece":
            pieces = [[_flip(p[0])] + list(p[1:]) for p in pieces]
        if Window.on and self.fault == "id":
            ids = [_flip(i) for i in ids]
        return ids, pieces

    def chunk_blobs_multi_finish(self, token):
        spans = super().chunk_blobs_multi_finish(token)
        if Window.on and self.fault == "boundary":
            out = []
            for s in spans:
                if len(s) >= 2:
                    (o0, l0), (o1, l1) = s[0], s[1]
                    s = [(o0, l0 - 1), (o1 - 1, l1 + 1)] + list(s[2:])
                out.append(s)
            spans = out
        return spans

    def decode_blobs_multi(self, jobs):
        blobs = super().decode_blobs_multi(jobs)
        if Window.on and self.fault == "decoded":
            blobs = [_flip(b) for b in blobs]
        if Window.on and self.fault == "half":
            blobs = blobs[:len(blobs) // 2] + [b""] * (len(blobs) - len(blobs) // 2)
        if Window.on and self.fault == "unchanged":
            blobs = [b"".join(p for _, p in sorted(pieces.items()))[:n]
                     for _, pieces, n in jobs]
        return blobs


def _drop_writes(monkeypatch, keep):
    from repro_torch.core.cluster import Cluster
    store_chunks = Cluster.store_chunks

    def dropping(self, items, min_pieces=None, reserved=0):
        if Window.on:
            items = keep(items)
        return store_chunks(self, items, min_pieces=min_pieces,
                            reserved=reserved)
    monkeypatch.setattr(Cluster, "store_chunks", dropping)


CELLS = {name: tiny.cell(name)[2]["loop"] for name in tiny.CELLS}
INGEST = [c for c, loop in CELLS.items() if loop == "ingest"]
READ = [c for c, loop in CELLS.items() if loop == "degraded_read"]


def _checks(name, eng):
    out = tiny.result(tiny.execute(name, eng=eng))
    assert not out["correct"]
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("name", INGEST)
@pytest.mark.parametrize("fault,caught", [("piece", "pieces_off"),
                                          ("id", "ids_off"),
                                          ("boundary", "boundaries_off")])
def test_put_answer_altered(window, name, fault, caught):
    eng = Faulty()
    eng.fault = fault
    assert _checks(name, eng)[caught] > 0


@pytest.mark.parametrize("name", INGEST)
@pytest.mark.parametrize("keep", [lambda items: [],
                                  lambda items: items[:len(items) // 2]],
                         ids=["unchanged", "half"])
def test_put_writes_left_out(window, monkeypatch, name, keep):
    _drop_writes(monkeypatch, keep)
    assert _checks(name, tiny.engine())["pieces_off"] > 0


@pytest.mark.parametrize("name", READ)
@pytest.mark.parametrize("fault", ["decoded", "half", "unchanged"])
def test_get_answer_faults(window, name, fault):
    eng = Faulty()
    eng.fault = fault
    assert _checks(name, eng)["gets_off"] > 0
