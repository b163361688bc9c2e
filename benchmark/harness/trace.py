"""A short steady slice of a run under torch.profiler: device busy time,
device time by operation and by kernel, and the idle gaps named by what
the host was doing.  Only this slice is profiled, so a traced run keeps
a few MiB of events in memory and writes none to disk."""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

from benchmark.harness import roofline, stats

#: Host ranges of the harness (`bench.<stage>`) and the port's spans: the
#: profiler projects them onto the device's timeline, where they are no
#: device work.
RANGE_PREFIXES = ("bench.", "ProfilerStep", "linalg", "sfm.")


@dataclasses.dataclass
class Profile:
    wall_s: float  # host clock over the slice, ended by a sync
    busy_s: float  # union of the device's operations
    device_ops: list  # [(name, seconds)], most time first
    idle_gaps: list  # [(host range, seconds)], summed by range, most first
    kernel_s: dict  # {kernel: device seconds} of the port's CUDA kernels
    service_s: float = 0.0  # the slice's own service time, where the driver gives it


def op_name(name: str, width: int = 160) -> str:
    """A profiler row's name without its trailing argument list, cut to
    `width` characters: "void f<256>(float const*, ...)" gives "void f<256>";
    copies ("Memcpy HtoD (Pinned -> Device)") keep theirs."""
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:width]


def _is_range(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(RANGE_PREFIXES)


def _host_range(cpu, starts, mid):
    """Name of the innermost host event open at `mid` (latest start)."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - 4000), -1):
        if cpu[j][1] >= mid:
            return cpu[j][2]
    return "host idle"


def profile(torch, step, n: int, names: dict, top: int = 10) -> Profile:
    """Run step(i) for i < n under torch.profiler and reduce its events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev, by_name, by_kernel = [], defaultdict(float), defaultdict(float)
    cpu = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if _is_range(e) or b <= a:
                continue
            dev.append((a, b))
            by_name[op_name(e.name)] += (b - a) / 1e6
            kernel = roofline.kernel_of(e.name, names)
            if kernel is not None:
                by_kernel[kernel] += (b - a) / 1e6
        elif b > a:
            cpu.append((a, b, e.name))
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for a, b in stats.gaps(dev):
        idle[_host_range(cpu, starts, 0.5 * (a + b))] += (b - a) / 1e6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return Profile(wall_s=wall, busy_s=stats.union_s(dev) / 1e6, device_ops=rank(by_name),
                   idle_gaps=rank(idle), kernel_s=dict(by_kernel))
