"""Each cell's control must come out not correct.

Ingest: the program's write-back path, which acknowledges a put before
its pieces land.  Degraded read: the reference's decode with the decode
skipped.  The CPU test runs them at small shapes; the card test at the
cell's own size, as ``bench/run.py --control``.
"""

import json
import pathlib
import subprocess
import sys

import pytest

from bench.harness import spec
from bench.tests import tiny

RUN = pathlib.Path(spec.BENCH) / "run.py"


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_is_not_correct(name):
    out = tiny.result(tiny.execute(name, control=True))
    assert not out["correct"], out["checks"]
    key = "pieces_off" if "ingest" in name else "gets_off"
    assert out["checks"][key]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.REGISTERED)
def test_control_is_not_correct_at_cell_size(card, name):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        proc = subprocess.run(
            [sys.executable, str(RUN), "--workload", name, "--seed",
             str(seed), "--seconds", "5", "--trace", "0", "--control"],
            capture_output=True, text=True, timeout=600,
            cwd=str(spec.ROOT))
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert not out["correct"], out["checks"]
