"""Host wall time inside the engine seam's calls, per logical MiB."""


def read(run):
    if run.spans is None or not run.mib:
        return None
    return run.spans.seconds("engine.") * 1e3 / run.mib
