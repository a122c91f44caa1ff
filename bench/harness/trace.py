"""Reduce a ``torch.profiler`` trace of the window to device numbers.

Device activity is every kernel, copy and memset the profiler saw on the
card (user-annotation ranges excluded).  Busy time is the union of those
intervals inside the window (``chip_smoke.profile_put`` summed them; a
union cannot count overlapping work twice), the idle share is one less
busy over the window, and each idle gap is named by the innermost
harness span (``Spans``) the host was in at the gap's middle.
"""

from __future__ import annotations

import dataclasses

WINDOW_SPAN = "window"


def _short(name: str) -> str:
    """A kernel's name without its argument list or return type."""
    head = name.split("(", 1)[0].strip()
    if head.startswith("void "):
        head = head[5:]
    return head


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s_by_name: dict[str, float]
    idle_s_by_span: dict[str, float]

    def device_s(self, needle: str) -> float:
        """Device seconds of every operation whose name holds ``needle``."""
        return sum(s for n, s in self.device_s_by_name.items()
                   if needle in n)

    def copy_s(self) -> float:
        return sum(s for n, s in self.device_s_by_name.items()
                   if n.startswith("Memcpy HtoD") or n.startswith("Memcpy DtoH"))

    def breakdown(self) -> dict:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_s_by_span.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, span_names: set[str]) -> Trace:
    """``events``: ``prof.events()``; ``span_names``: the harness's spans."""
    from torch.autograd import DeviceType

    spans, device = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        annotation = getattr(e, "is_user_annotation", False) \
            or e.name in span_names
        if e.device_type == DeviceType.CUDA:
            if not annotation and b > a:
                device.append((e.name, a, b))
        elif e.name in span_names:
            spans.append((e.name, a, b))
    windows = [(a, b) for n, a, b in spans if n == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0]
    by_name: dict[str, float] = {}
    inside = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        inside.append((a, b))
        key = _short(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
    busy = _union(inside)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    inner = sorted((s for s in spans if s[0] != WINDOW_SPAN),
                   key=lambda s: s[1])
    idle: dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "harness"
        for n, s0, s1 in inner:
            if s0 > mid:
                break
            if s1 >= mid:
                name = n  # the latest-opened span still open: innermost
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                 device_s_by_name=by_name, idle_s_by_span=idle)
