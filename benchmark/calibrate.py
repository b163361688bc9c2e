#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the GPU, in one
process: for each seed a run of the cell with a short window, the numbers
of the program's sampled outputs against the reference, and for the
control seeds the numbers of the control (the reference with every plane
of the scale space stored in bfloat16, put in the program's place) on the
same sampled inputs.

    python3 benchmark/calibrate.py --workload tum_vga.batch128 --seeds 11,12,13 --control 11,12,13 --seconds 3

One JSON line per reading; the last line holds, per number, the largest
reading of the program and the smallest of the control.  The benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    ap.add_argument("--control", default="", help="comma-separated seeds of the control's readings")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness import runner

    bench = spec.Bench.load(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    high, low = {}, {}
    for seed in sorted(set(seeds) | control):
        cell = bench.cell(args.workload)
        run, drv = runner.setup(cell, seed, False, torch.device("cuda", 0))
        drv.window(args.seconds)
        drv.release()
        t = time.perf_counter()
        refs = drv.reference()
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t
        readings = []
        if seed in seeds:
            readings.append(("program", drv.numbers(drv.outputs(), refs)))
        if seed in control:
            readings.append(("control", drv.numbers(drv.reference(lowp=True), refs)))
        for who, numbers in readings:
            side = high if who == "program" else low
            for name, value in numbers.items():
                side[name] = (max if who == "program" else min)(side.get(name, value), value)
            print(json.dumps({"seed": seed, "who": who, "numbers": numbers, "calls": run.calls,
                              "sampled": len(drv.sample), "reference_s": ref_s}), flush=True)
        del run, drv, refs
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": high, "control_min": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
