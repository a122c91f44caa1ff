"""K5's device time in the window against the least time its jobs need.

The jobs are those the engine's ``hash_encode_blobs_multi`` received in
the window, each distinct (code, chunk) once, as the engine coalesces
them; see ``bench/harness/yardstick.py``.
"""

from bench.harness import yardstick


def read(run):
    t, spans = run.trace_result, run.spans
    if t is None or spans is None or run.peak is None:
        return None
    kernel_s = t.device_s("fused_ingest")
    unique = {(n, k, blob) for n, k, blob in spans.fused_jobs}
    if not kernel_s or not unique:
        return None
    nbytes, ops = yardstick.fused_ingest_work(
        (n, k, len(blob)) for n, k, blob in unique)
    least, _ = yardstick.bound(nbytes, ops, run.peak["ops_per_s"])
    return 100.0 * least / kernel_s
