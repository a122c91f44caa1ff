"""95th percentile of submit to resolved, over the window's puts."""

from bench.harness.readers import p95


def read(run):
    return p95(run.put_ms)
