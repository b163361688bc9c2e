"""The arithmetic of the end-to-end and per-layer metrics."""

from __future__ import annotations

import statistics


def rate(units: float, seconds: float) -> float | None:
    """Work per second over the whole window; None for an empty window."""
    return units / seconds if seconds > 0 and units > 0 else None


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0-100) of every value, linearly interpolated
    between the closest ranks (numpy's default); None for no values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals) -> list:
    """The (start, end) gaps between the merged (start, end) intervals."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def idle_pct(busy_s: float, wall_s: float) -> float | None:
    """100 * (1 - busy / wall); None where nothing was measured."""
    return 100.0 * (1.0 - busy_s / wall_s) if wall_s > 0 and busy_s > 0 else None
