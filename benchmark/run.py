#!/usr/bin/env python3
"""Run one cell of the benchmark of akaze_tpu_torch once.

    python3 benchmark/run.py --workload tum_vga.batch128 --seed 7 --seconds 20 --trace 0

The cell, its configuration and its traffic mix are found by name through
BENCHMARK.json at the root of the checkout.  The last line on standard
output is one JSON object (correct, attempted, failed, metrics, device;
with --trace 1 also breakdown, and the numbers compared with their limits
last under "checks"); the same numbers end standard error.  The run exits
non-zero and prints no result where the cell's GPUs are missing, where the
program cannot be imported, or where the process has loaded JAX or the JAX
package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))

    from benchmark.harness import guard, spec

    bench = spec.Bench.load(ROOT)
    cell = bench.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s), {have} available", file=sys.stderr)
        return 2
    try:
        from benchmark.harness import runner  # imports the program
    except ImportError as exc:
        print(f"run.py: the program cannot be imported: {exc}", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))

    result, rows, notes = runner.execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                                         torch.device("cuda", 0))
    found = guard.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    runner.emit(result, rows, notes, sys.stdout, sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
