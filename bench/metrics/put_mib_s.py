"""Logical MiB of every put acknowledged in the window, a second of it."""

from bench.harness.runner import MiB


def read(run):
    return run.put_bytes / MiB / run.window_s if run.put_bytes else None
