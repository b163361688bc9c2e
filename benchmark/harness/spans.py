"""Idle gaps and device operations of a profiled slice, each given to the
program span that issued it.

Under torch.profiler each `akaze_tpu_torch.utils.profiling.span` is a
`record_function` range on the profiler's host clock, beside the device's
operations and the CUDA runtime calls that launched them.  An idle gap of
the device goes to the innermost span open at its middle; a device
operation (kernel, copy, memset) goes to the innermost span open at its
runtime call, which the profiler links to it by correlation id.  Outside
every span is `OUTSIDE` (the caller's loop); an operation with no linked
runtime call is `UNLINKED`.

`trace.profile` does not call this yet: a traced run's `breakdown` does not
carry it, and no metric reads it (`PERF.md` §7).  `tools/span_profile.py`
prints it for a cell.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from benchmark.harness import stats, trace

OUTSIDE = "outside"
UNLINKED = "unlinked"


def innermost(spans: list, starts: list, t: float) -> str:
    """Name of the innermost of `spans` ((start, end, name), sorted by
    start, outer first on a tie; `starts` their starts) open at `t`: the
    latest started that has not ended.  Spans of one thread nest, so that
    is the innermost."""
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return OUTSIDE


def by_span(ops: list, spans: list, launch_at: dict) -> list:
    """[[span, idle seconds, device operations, device seconds]], most
    idle first, of device operations `ops` ((start, end, correlation id),
    microseconds), program spans `spans` ((start, end, name)) and the host
    time of each correlation id's runtime call (`launch_at`)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))  # on a tie the outer span first
    starts = [s[0] for s in spans]
    rows = defaultdict(lambda: [0.0, 0, 0.0])
    for a, b in stats.gaps([(a, b) for a, b, _ in ops]):
        rows[innermost(spans, starts, 0.5 * (a + b))][0] += (b - a) / 1e6
    for a, b, corr in ops:
        at = launch_at.get(corr)
        row = rows[UNLINKED if at is None else innermost(spans, starts, at)]
        row[1] += 1
        row[2] += (b - a) / 1e6
    return sorted(([name, *row] for name, row in rows.items()), key=lambda r: (-r[1], -r[2], r[0]))


def of_events(torch, events) -> tuple:
    """(ops, spans, launch_at) of a finished profile's events: the device's
    operations without the ranges projected onto its timeline, the user
    annotations on the host (the program's spans), and the start of each
    CUDA API call (`cuda*`, `cu*`) by its correlation id."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, spans, launch_at = [], [], {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if not trace._is_range(e) and b > a:
                ops.append((a, b, e.id))
        elif getattr(e, "is_user_annotation", False):
            spans.append((a, b, e.name))
        elif e.name.startswith("cu"):
            launch_at[e.id] = a
    return ops, spans, launch_at
