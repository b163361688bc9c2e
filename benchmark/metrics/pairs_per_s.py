"""pairs_per_s: image pairs whose relative pose completed in the window, over the window (host clock, ended by a sync)."""

from benchmark.harness.stats import rate


def read(run):
    return rate(run.units.get("pairs", 0), run.window_s)
