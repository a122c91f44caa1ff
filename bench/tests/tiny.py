"""Small shapes of the benchmark's cells, for runs on the CPU.

The same configurations and loops as ``BENCHMARK.json``, with the mixes
cut down so that a whole run (set-up, window, check) takes well under a
second with the program's host engine.
"""

from __future__ import annotations

import copy
import time

from bench.harness import runner, spec

KiB = 1 << 10

# mixes kept under bench/mixes for later cells, run here so they stay sound
LATER = {"archival.ingest": "sears-archival-rs14-10",
         "archival.degraded_read": "sears-archival-rs14-10"}
REGISTERED = [w["name"] for w in spec.benchmark()["workloads"]]
CELLS = REGISTERED + [n for n in LATER if n not in REGISTERED]


def engine():
    """The program's host engine, taking the fused ingest seam."""
    from repro_torch.core import NumpyEngine

    class HostFused(NumpyEngine):
        supports_fused_ingest = True

    return HostFused()


def cell(name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, mix) of a cell of ``BENCHMARK.json`` or of
    ``LATER``, cut."""
    bench = spec.benchmark()
    if name in REGISTERED:
        c = spec.cell(bench, name)
        cfg = spec.config(bench, c["config"])
    else:
        c = {"name": name, "config": LATER[name], "traffic": name,
             "chips": 1}
        cfg = spec.load_json(spec.BENCH / "configs" / f"{LATER[name]}.json")
    mix = copy.deepcopy(spec.mix(c["traffic"]))
    content = mix["content"]
    content["users"] = min(content["users"], 3)
    content["files_per_user"] = min(content["files_per_user"], 3)
    content["file_bytes"] = 48 * KiB
    content["block"] = 4 * KiB
    if content["pool_blocks"]:
        content["pool_blocks"] = 8
    if mix["loop"] == "ingest":
        mix["reserve_rounds"] = 100
        mix["sample_files"] = 3
    else:
        mix["gets_per_user"] = min(mix["gets_per_user"],
                                   content["files_per_user"])
        mix["reserve_rounds"] = 200
    return c, cfg, mix


def execute(name: str, seed: int = 2**31 + 11, seconds: float = 0.05,
            trace: bool = False, control: bool = False, eng=None,
            mutate=None):
    """Run a cut cell on the CPU; ``mutate(cell, cfg, mix)`` may edit it."""
    c, cfg, mix = cell(name)
    if mutate is not None:
        mutate(c, cfg, mix)
    import torch
    run = runner.execute(c, cfg, mix, seed, seconds, trace,
                         torch.device("cpu"), time.perf_counter(),
                         engine=eng or engine(), control=control)
    run.peak = {"ops_per_s": 1e12}
    return run


def result(run) -> dict:
    info = {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
    return runner.report(run, spec.benchmark(), info)
