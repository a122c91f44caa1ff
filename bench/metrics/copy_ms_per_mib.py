"""Device time of host-to-device and device-to-host copies, per logical MiB."""


def read(run):
    t = run.trace_result
    if t is None or not run.mib or not t.copy_s():
        return None
    return t.copy_s() * 1e3 / run.mib
