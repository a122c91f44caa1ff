"""Nothing ``bench/run.py`` loads may be JAX or the JAX package.

The check compares each module's top-level name (before the first dot)
whole: ``repro_torch`` is the program, ``repro`` the JAX package.  A
subprocess blocks those names at import, loads the harness, every loop
and metric reader, drives a small run of every cell on the CPU, and
lists what ``sys.modules`` holds.  The reference imports nothing of the
program either.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

from bench.harness import spec

ROOT = pathlib.Path(spec.ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

PROBE = r"""
import importlib.abc, json, sys
FORBIDDEN = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".", 1)[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[2] + "/src", sys.argv[2]]
import runpy
runpy.run_path(sys.argv[2] + "/bench/run.py", run_name="bench_run")
from bench.harness import spec
from bench.tests import tiny
bench = spec.benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
for i, w in enumerate(bench["workloads"]):
    tiny.result(tiny.execute(w["name"], trace=i == 0))
print(json.dumps(sorted(sys.modules)))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_nothing_loaded_is_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, ",".join(FORBIDDEN), str(ROOT)],
        capture_output=True, text=True, timeout=300, env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch" in mods
    assert [m for m in mods if m.split(".", 1)[0] in FORBIDDEN] == []


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".", 1)[0]
                assert top in ("__future__", "functools", "hashlib",
                               "numpy", "bench"), (path.name, name)


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "realtime.ingest", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=str(ROOT))
    assert proc.returncode != 0
    assert "{" not in proc.stdout
