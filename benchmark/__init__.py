"""The benchmark of akaze_tpu_torch: `python benchmark/run.py --workload <cell> ...`."""
