"""Device idle share (%) of the profiled slice: 100 x (1 - busy / wall), busy the union of the device's operations."""

from benchmark.harness.stats import idle_pct


def read(run):
    return idle_pct(run.profile.busy_s, run.profile.wall_s) if run.profile is not None else None
