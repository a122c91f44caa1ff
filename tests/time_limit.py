"""A time limit on every test, from the standard library alone.

A pytest plugin (the repo's root ``conftest.py`` loads it for every
run).  Each test's setup, call and teardown run under one ``SIGALRM``
timer of ``LIMIT`` seconds, or of the seconds its marker gives
(``@pytest.mark.limit(600)``).  Just before the timer fires,
``faulthandler`` prints every thread's stack to stderr, where a hang in
C code shows too; then the test fails with a message that names its
limit, and the run goes on with the next test.  Past the limit the timer
fires again every ``GRACE`` seconds, so a teardown that hangs fails too.
A firing between the phases, in pytest's own reporting, waits for the
next one.

Python runs the failing handler on the main thread only between
bytecodes, or when a system call the thread waits in (a sleep, a pipe, a
``wait``) returns interrupted.  A hang inside C code that neither
returns nor gives way to the signal (a native loop, a call that retries
on ``EINTR`` itself) gets its stacks dumped but is not failed: the run
then waits on it.

The timer needs the main thread, where pytest-xdist's workers run their
tests; elsewhere (or without ``SIGALRM``) tests run unlimited.
"""

from __future__ import annotations

import faulthandler
import signal
import threading
import time

import pytest

LIMIT = 300.0
GRACE = 30.0
_in_phase = [False]  # a test's setup, call or teardown is running


def _limit_of(item) -> float:
    """The seconds ``item`` may take: its ``limit`` marker's, else
    ``LIMIT``."""
    mark = item.get_closest_marker("limit")
    return float(mark.args[0]) if mark else LIMIT


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    seconds = _limit_of(item)
    start = time.monotonic()

    def expire(signum, frame):
        if not _in_phase[0]:
            return
        pytest.fail(f"{item.nodeid} is past its time limit of {seconds:g} s "
                    f"({time.monotonic() - start:.1f} s; every thread's "
                    "stack is on stderr)")

    previous = signal.signal(signal.SIGALRM, expire)
    faulthandler.dump_traceback_later(seconds - min(1.0, seconds / 10))
    signal.setitimer(signal.ITIMER_REAL, seconds, GRACE)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


def _phase():
    @pytest.hookimpl(hookwrapper=True)
    def run(item):
        _in_phase[0] = True
        try:
            yield
        finally:
            _in_phase[0] = False
    return run


pytest_runtest_setup = _phase()
pytest_runtest_call = _phase()
pytest_runtest_teardown = _phase()
