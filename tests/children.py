"""Child processes that a test starts together: the multi-rank fixtures'
gloo ranks and reference runs, and the launchers.

``Children`` starts them at once and reads their output from the start,
so no pipe fills while the test works on.  ``wait`` waits for all of
them under one deadline and, as soon as one exits non-zero or the
deadline passes, kills every one still running: a rank that died no
longer leaves its peers blocked in a collective.  Leaving the ``with``
block kills whatever still runs, also when the test failed meanwhile or
its time limit fired.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import signal
import subprocess
import threading
import time
from typing import NamedTuple

ROOT = pathlib.Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def one_thread():
    """torch on one thread in this process while its children compute:
    with a thread a core, the parent's plain runs and the ranks fight
    for the cores (on 8 cores the MoE fixture's plain runs took 89 s so,
    2.6 s on one thread)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class Exit(NamedTuple):
    returncode: int
    out: str
    err: str


class Children:
    """``subprocess.Popen(argv)`` of each of ``argvs`` from the repo's
    root, with text pipes for stdout and stderr, each in a session of its
    own (a kill takes its whole process group).  Their environment is
    this one with the repo's ``src`` on the path, gloo over loopback, one
    OpenMP thread and JAX on the CPU."""

    def __init__(self, argvs):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        self.procs, self._outs, self._readers = [], [], []
        for argv in argvs:
            p = subprocess.Popen(argv, cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 start_new_session=True)
            self.procs.append(p)
            self._outs.append({})
            for name, pipe in (("out", p.stdout), ("err", p.stderr)):
                t = threading.Thread(target=self._read, daemon=True,
                                     args=(pipe, self._outs[-1], name))
                t.start()
                self._readers.append(t)

    @staticmethod
    def _read(pipe, into: dict, name: str) -> None:
        into[name] = pipe.read()
        pipe.close()

    def __enter__(self) -> "Children":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()

    def kill(self) -> None:
        """SIGKILL to every child still running, and reap it."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        for p in self.procs:
            p.wait()
        for t in self._readers:
            t.join(timeout=10)

    def wait(self, timeout: float) -> list[Exit]:
        """Every child's exit status and output, once all have exited, or
        one has exited non-zero, or ``timeout`` seconds have passed; the
        children still running then are killed (``returncode`` -9)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in self.procs]
            if None not in codes or any(codes):
                break
            time.sleep(0.05)
        self.kill()
        return [Exit(p.returncode, o.get("out", ""), o.get("err", ""))
                for p, o in zip(self.procs, self._outs)]


def failures(exits: list[Exit], tail: int = 4000) -> str:
    """The stderr tails of the children that exited non-zero, those that
    failed on their own before those killed after them; '' if none."""
    bad = sorted((e.returncode == -signal.SIGKILL, i, e)
                 for i, e in enumerate(exits) if e.returncode)
    return "\n".join(f"-- child {i} exited {e.returncode}:\n{e.err[-tail:]}"
                     for _, i, e in bad)
