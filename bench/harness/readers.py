"""Arithmetic the metric readers share."""

from __future__ import annotations


def p95(values) -> float | None:
    """The nearest-rank 95th percentile, None without values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, -(-95 * len(ordered) // 100) - 1)]
