"""The harness's own spans, recorded from outside the program.

``Spans.wrap_engine`` replaces the engine seam's entry points on one
store's engine instance with timed wrappers (no program file changes):
each call is a span named ``engine.<method>``, also opened as a
``torch.profiler.record_function`` range so the device trace can name
what the host was doing in each idle gap.  ``Spans.span`` records the
harness's own regions the same way (``flush``: a round's coalesced
window).  The wrappers also keep the jobs that each outermost engine
call received, for the yardstick.
"""

from __future__ import annotations

import contextlib
import time

ENGINE_METHODS = ("chunk_blobs_multi_begin", "chunk_blobs_multi_finish",
                  "hash_chunks", "hash_encode_blobs_multi",
                  "encode_blobs_multi", "decode_blobs_multi",
                  "decode_blobs_multi_begin", "decode_blobs_multi_finish",
                  "recode_blobs_multi")


class Spans:
    def __init__(self) -> None:
        from torch.profiler import record_function
        self._record = record_function
        self.records: list[tuple[str, float, float]] = []
        self.fused_jobs: list[tuple] = []  # (n, k, blob) per job received
        self.decode_jobs: list[tuple] = []  # (n, k, indices, nbytes)
        self._engine_depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with self._record(name):
                yield
        finally:
            self.records.append((name, t0, time.perf_counter()))

    def wrap_engine(self, engine) -> None:
        for name in ENGINE_METHODS:
            fn = getattr(engine, name, None)
            if fn is not None:
                setattr(engine, name, self._wrapped(name, fn))

    def _wrapped(self, name: str, fn):
        def call(jobs, *args, **kwargs):
            if self._engine_depth == 0:
                self._note_jobs(name, jobs)
            self._engine_depth += 1
            try:
                with self.span("engine." + name):
                    return fn(jobs, *args, **kwargs)
            finally:
                self._engine_depth -= 1
        return call

    def _note_jobs(self, name: str, jobs) -> None:
        if name == "hash_encode_blobs_multi":
            self.fused_jobs.extend((code.n, code.k, blob)
                                   for code, blob in jobs)
        elif name in ("decode_blobs_multi", "decode_blobs_multi_begin"):
            self.decode_jobs.extend(
                (code.n, code.k, tuple(sorted(pieces)), nbytes)
                for code, pieces, nbytes in jobs)

    def seconds(self, prefix: str) -> float:
        """Wall seconds covered by spans whose name starts with ``prefix``
        (nested spans of the prefix counted once)."""
        total, reach = 0.0, float("-inf")
        for t0, t1 in sorted((t0, t1) for name, t0, t1 in self.records
                             if name.startswith(prefix)):
            if t1 > reach:
                total += t1 - max(t0, reach)
                reach = t1
        return total
