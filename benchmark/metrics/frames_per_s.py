"""frames_per_s: frames whose features and matches completed in the window, over the window (host clock, ended by a sync)."""

from benchmark.harness.stats import rate


def read(run):
    return rate(run.units.get("frames", 0), run.window_s)
