"""The port's examples run end to end on the CPU, at their smallest sizes.

Each of ``examples/torch_*.py`` runs in a subprocess with ``--device
cpu`` (``torch_train_lm.py`` with ``--tiny``, a crash and a restart, as
the chip smoke runs it on the card) and must exit 0 with its own checks
passed.  The four start together, one intra-op thread each, and each
test waits for its own.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

EXAMPLES = {
    "torch_quickstart": [],
    "torch_serve_lm": ["--arch", "gemma3_1b", "--tokens", "8"],
    "torch_train_lm": ["--tiny", "--steps", "20", "--ckpt-every", "10",
                       "--crash-at", "10"],
    "torch_checkpoint_restore": [],
}
EXPECT = {
    "torch_quickstart": "retrieval with 5/10 nodes dead: OK",
    "torch_serve_lm": "sample token ids:",
    "torch_train_lm": "simulated crash at step 10",
    "torch_checkpoint_restore": "restore bit-exact onto a (1, 1) mesh: True",
}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *argv,
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, argv in EXAMPLES.items()}
    try:
        yield procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(runs, name):
    out, err = runs[name].communicate(timeout=240)
    assert runs[name].returncode == 0, err[-4000:]
    assert EXPECT[name] in out, out
    if name == "torch_train_lm":  # the restart resumed at step 10
        assert out.count("step    10 ") == 1 and "step    20 " in out
