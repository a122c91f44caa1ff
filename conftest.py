"""Settings of every pytest run in this repo (``tests`` and ``bench/tests``).

* Every test runs under a time limit (``tests/time_limit.py``).
* One XLA compilation cache for the run: the first process (the xdist
  controller, or the only one) makes a temporary directory and exports
  it as ``JAX_COMPILATION_CACHE_DIR``, so every worker and every
  subprocess a test starts compiles an executable the others have
  compiled no more; it removes the directory when the run ends, so no
  run reads another's.
* Under xdist, torch's and XLA's CPU threads are the cores over the
  workers (at least one), set before either library is imported.
* XLA:CPU compiles with its older emitters, not its fusion emitters
  (the comment at ``_add_xla_flag``'s call says why).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import sys
import tempfile

import pytest

# by file, not as ``tests.time_limit``: an installed package named
# ``tests`` would shadow this directory's
_TESTS = str(pathlib.Path(__file__).resolve().parent / "tests")
if _TESTS not in sys.path:
    sys.path.insert(0, _TESTS)
pytest_plugins = ["time_limit"]

_CACHE_DIR = pytest.StashKey[str]()  # the cache directory this run made


def _add_xla_flag(flag: str) -> None:
    flags = os.environ.get("XLA_FLAGS", "")
    if flag.split("=")[0] not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} {flag}".strip()


def _set_threads() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    n = str(max(1, len(os.sched_getaffinity(0)) // int(workers)))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = n
    if n == "1":  # XLA:CPU takes no count, only one thread or all
        _add_xla_flag("--xla_cpu_multi_thread_eigen=false")


_set_threads()
# XLA:CPU's fusion emitters compile the reference's jitted SHA-1 oracle
# (a fori_loop over 128 blocks) to code that runs 9 s a launch of 32
# messages and compiles in 12 s on an 8-core x86 host; the older emitters
# give the same digests there in 6 ms and 1.3 s
_add_xla_flag("--xla_cpu_use_fusion_emitters=false")


def pytest_configure(config):
    if "PYTEST_XDIST_WORKER" in os.environ or \
            "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return
    path = config.stash[_CACHE_DIR] = tempfile.mkdtemp(prefix="jax-cache-")
    os.environ.update(JAX_COMPILATION_CACHE_DIR=path,
                      JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")


def pytest_unconfigure(config):
    if _CACHE_DIR in config.stash:
        shutil.rmtree(config.stash[_CACHE_DIR], ignore_errors=True)
