"""idle_pct.live: device idle share (%) of the profiled frames' own service time (the gaps between due times left out)."""

from benchmark.harness.stats import idle_pct


def read(run):
    prof = run.profile
    return idle_pct(prof.busy_s, prof.service_s) if prof is not None else None
