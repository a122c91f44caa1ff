"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell names a configuration (``configs[].file``) and a traffic mix
(``bench/mixes/<traffic>.json``); the mix names its loop
(``bench/loops/<loop>.py``); each metric is read by
``bench/metrics/<name>.py``, or, for a name with a suffix after a dot
(``host_ms_per_mib.read``), by the reader of the part before the first
dot where the suffixed file does not exist.  Adding a configuration, a
mix, a loop or a metric is adding files.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(traffic: str) -> dict:
    return load_json(BENCH / "mixes" / f"{traffic}.json")


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str):
    return _module(BENCH / "loops" / f"{name}.py", f"bench_loop_{name}")


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.', 1)[0]}.py"
    return _module(path, "bench_metric_" + path.stem.replace(".", "_"))


def metrics_for(spec: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: a
    per-layer metric names its cells under ``workloads``; an end-to-end
    metric without the key is reported in every cell."""
    out = []
    for m in spec[kind]:
        cells = m["workloads"] if kind == "per_layer" else m.get("workloads")
        if cells is None or cell_name in cells:
            out.append(m)
    return out
