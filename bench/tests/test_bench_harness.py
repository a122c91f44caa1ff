"""The harness end to end on the CPU, at small shapes of every cell."""

import json
import pathlib
import re

import pytest

from bench.harness import runner, spec
from bench.tests import tiny

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(name, trace):
    run = tiny.execute(name, trace=trace)
    out = tiny.result(run)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_for(BENCH, name, kind)}
    got = set(out["metrics"])
    # device readings need the card: on the CPU those readers find nothing
    device_only = {m["name"] for m in BENCH["per_layer"]
                   if m["source"] == "device_trace"}
    assert want - device_only <= got <= want
    if trace:
        assert out["device"]["window_s"] > 0
        assert "breakdown" in out
    else:
        assert out["metrics"]["setup_s"]["value"] > 0


def test_ingest_reads_the_space_the_window_cost():
    run = tiny.execute("realtime.ingest")
    assert run.put_bytes > 0
    value = spec.reader("stored_bytes_per_byte").read(run)
    # pooled blocks dedup, private ones cost n/k = 2 and the index
    assert 0.5 < value < 2.2


def test_degraded_read_counts_the_pieces_it_read():
    run = tiny.execute("realtime.degraded_read")
    assert run.get_bytes > 0
    value = spec.reader("read_bytes_per_byte").read(run)
    # k of n pieces a chunk, each a k-th of it and padded; a chunk that
    # several gets of one flush share is read once
    assert 0.5 < value < 1.1


def test_reserve_exhausted_fails_the_run():
    def short(cell, cfg, mix):
        mix["reserve_rounds"] = 1
    with pytest.raises(runner.ReserveExhausted):
        tiny.execute("realtime.ingest", seconds=60, mutate=short)


def test_every_cell_metric_and_file_is_found_by_name():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        assert NAME.match(m["name"])
    for w in BENCH["workloads"]:
        mix = spec.mix(w["traffic"])
        assert callable(spec.loop(mix["loop"]).round)
        assert spec.config(BENCH, w["config"])["name"] == w["config"]
        reported = {m["moves"] for m in spec.metrics_for(
            BENCH, w["name"], "per_layer")}
        e2e = {m["name"] for m in spec.metrics_for(BENCH, w["name"],
                                                   "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2 and reported <= e2e


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    root = pathlib.Path(spec.ROOT)
    assert len(json.dumps(BENCH)) < 64 << 10
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (root / c["file"]).exists()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert all(m["workloads"] for m in BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 for x in layers)
