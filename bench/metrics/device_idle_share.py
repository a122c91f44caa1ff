"""Share of the window in which nothing ran on the device, in percent."""


def read(run):
    t = run.trace_result
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
