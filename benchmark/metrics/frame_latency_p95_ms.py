"""frame_latency_p95_ms: 95th percentile over every frame of the window of the time from the frame's due time to its features and matches on the host."""

from benchmark.harness.stats import percentile


def read(run):
    return percentile(run.latencies_ms, 95)
