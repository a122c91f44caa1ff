"""K1's device time in the window against the least time its decodes need.

The jobs are those the engine's decode entry received in the window
whose pieces are not the k systematic ones (those are copied, not
decoded); the GF products count as bytes, see
``bench/harness/yardstick.py``.
"""

from bench.harness import yardstick


def read(run):
    t, spans = run.trace_result, run.spans
    if t is None or spans is None or run.peak is None:
        return None
    kernel_s = t.device_s("gf_matmul")
    jobs = [(k, nbytes) for n, k, idx, nbytes in spans.decode_jobs
            if idx[:k] != tuple(range(k))]
    if not kernel_s or not jobs:
        return None
    least, _ = yardstick.bound(yardstick.decode_work(jobs), 0,
                               run.peak["ops_per_s"])
    return 100.0 * least / kernel_s
