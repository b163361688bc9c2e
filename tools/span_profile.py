#!/usr/bin/env python3
"""The port's spans in a benchmark cell, on the card: device ms per span
and the idle gaps and device operations by span.

    python3 tools/span_profile.py --workload tum_vga.batch128 --seed 7 --calls 8 --profile-calls 2

Sets the cell up as `benchmark/run.py` does (its pool, draws and warm-up).
With `--window` it first times the cell's closed loop with every span off
and with the spans recorded, in turns (what tracing costs when on).  Then
it runs `--calls` calls under a `utils.profiling.SpanRecorder` (each
span's CUDA-event ms and self ms per call), and `--profile-calls` calls
under torch.profiler, reduced by `benchmark/harness/spans.py` (idle
seconds, device operations and their device seconds by the innermost span,
per call), the last call's per-level top-K planes by path and its
contrast-factor frames by path.  Prints one
JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--profile-calls", type=int, default=2)
    ap.add_argument("--window", type=float, default=0.0,
                    help="seconds of each of four closed-loop windows, spans off, on, on, off (0: none)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import runner, spans, spec, stats
    from akaze_tpu_torch.kernels import contrast, topk
    from akaze_tpu_torch.utils.profiling import SpanRecorder, record_spans

    if not torch.cuda.is_available():
        print("span_profile.py: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = spec.Bench.load(ROOT).cell(args.workload)
    _, drv = runner.setup(cell, args.seed, False, dev)

    def rate(on: bool) -> float:
        """Units per second of a closed loop over `--window` seconds, with a
        recorder on or with every span off."""
        with record_spans(SpanRecorder()) if on else contextlib.nullcontext():
            torch.cuda.synchronize(dev)
            t0, i = time.perf_counter(), 0
            while time.perf_counter() - t0 < args.window:
                drv.step(i)
                i += 1
            torch.cuda.synchronize(dev)
            return i * drv.per_call / (time.perf_counter() - t0)

    rates = [[on, rate(on)] for on in (False, True, True, False)] if args.window > 0 else []

    rec = SpanRecorder()
    with record_spans(rec):
        for i in range(args.calls):
            drv.step(i)
    torch.cuda.synchronize(dev)
    names = list(dict.fromkeys(s.name for s in rec.spans))
    span_ms = {n: [rec.ms(n) / args.calls, rec.self_ms(n) / args.calls, rec.count(n) / args.calls] for n in names}

    n = args.profile_calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            drv.step(args.calls + i)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ops, marks, launch_at = spans.of_events(torch, prof.events())
    rows = spans.by_span(ops, marks, launch_at)
    unlinked = sum(r[2] for r in rows if r[0] == spans.UNLINKED)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": runner.card_line(),
        "rates": rates,  # [[spans recorded, units per second]]
        "span_ms_per_call": span_ms,  # {span: [ms, self ms, spans]} per call, CUDA events
        "profiled_calls": n, "wall_s": wall, "busy_s": stats.union_s([(a, b) for a, b, _ in ops]) / 1e6,
        "launches_per_call": len(ops) / n, "unlinked_share": unlinked / len(ops) if ops else None,
        "by_span": [[name, idle / n, count / n, device / n] for name, idle, count, device in rows],
        "topk_paths": topk.path_counts(),  # the last call's per-level top-K planes by path
        "contrast_paths": contrast.path_counts(),  # the last call's contrast-factor frames by path
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
