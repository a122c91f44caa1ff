"""The test harness's own guards: the per-test time limit
(``tests/time_limit.py``) and the children of the multi-rank tests
(``tests/children.py``)."""

from __future__ import annotations

import os
import pathlib
import sys
import time

import pytest

from children import Children, failures

pytest_plugins = ["pytester"]

TESTS = pathlib.Path(__file__).resolve().parent


def test_time_limit_fails_a_test_past_it_and_the_run_goes_on(pytester,
                                                             monkeypatch):
    """A test asleep past its 1 s limit fails with the limit's message
    (its stacks dumped first); the next test still runs and passes, and
    a test under its limit is untouched."""
    pytester.makeini("[pytest]\nmarkers =\n    limit(seconds): a limit\n")
    pytester.makepyfile(test_sleeps="""
        import time
        import pytest

        @pytest.mark.limit(1)
        def test_past_its_limit():
            time.sleep(30)

        def test_next():
            assert True

        @pytest.mark.limit(5)
        def test_under_its_limit():
            time.sleep(0.2)
    """)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(TESTS), os.environ.get("PYTHONPATH", "")]))
    t0 = time.monotonic()
    res = pytester.runpytest_subprocess("-p", "time_limit", "-p",
                                        "no:cacheprovider", "-v")
    took = time.monotonic() - t0
    res.assert_outcomes(passed=2, failed=1)
    res.stdout.fnmatch_lines([
        "*test_past_its_limit FAILED*", "*test_next PASSED*",
        "*test_under_its_limit PASSED*",
        "*is past its time limit of 1 s*"])
    assert "Timeout (0:00:00" in res.stdout.str() + res.stderr.str()
    assert took < 25


def test_children_kill_every_peer_when_one_fails():
    """One of three children exits 1 at once, two sleep 60 s: ``wait``
    returns within seconds with the failing child's stderr, and every
    child has exited."""
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    fail = [sys.executable, "-c",
            "import sys; print('rank 1 is dead', file=sys.stderr); "
            "sys.exit(1)"]
    t0 = time.monotonic()
    with Children([sleep, fail, sleep]) as children:
        exits = children.wait(120)
    assert time.monotonic() - t0 < 15
    assert [e.returncode for e in exits] == [-9, 1, -9]
    assert "rank 1 is dead" in exits[1].err
    assert failures(exits).startswith("-- child 1 exited 1:\nrank 1 is dead")
    assert all(p.poll() is not None for p in children.procs)


def test_children_kill_every_child_at_the_deadline_and_on_leaving():
    """Past ``wait``'s deadline every child is killed; leaving the block
    early (a test that fails meanwhile) kills them too."""
    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    with Children([sleep, sleep]) as children:
        exits = children.wait(1)
    assert [e.returncode for e in exits] == [-9, -9]
    with pytest.raises(RuntimeError), Children([sleep]) as children:
        raise RuntimeError("the test failed while its child ran")
    assert children.procs[0].poll() == -9
    with Children([[sys.executable, "-c", "print('ok')"]]) as children:
        (done,) = children.wait(60)
    assert done == (0, "ok\n", "") and failures([done]) == ""
