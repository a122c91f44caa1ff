"""Flush wall time outside the engine seam's calls, per logical MiB."""


def read(run):
    if run.spans is None or not run.mib:
        return None
    host = run.spans.seconds("flush") - run.spans.seconds("engine.")
    return host * 1e3 / run.mib
