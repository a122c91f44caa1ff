"""Logical MiB of every get returned in the window, a second of it."""

from bench.harness.runner import MiB


def read(run):
    return run.get_bytes / MiB / run.window_s if run.get_bytes else None
