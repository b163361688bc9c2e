"""One run of one cell: set-up, the timed window, the traced slice, the
comparison with the reference, and the result line.

`execute` takes the device, so the CPU tests drive a whole run through the
program's plain twins at small sizes; `benchmark/run.py` refuses to run
without the GPUs a cell asks for.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import time

import torch

from benchmark.harness import check, drivers, stats

_CLOCK_START = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's start time;
    since this module's import where /proc is not readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _CLOCK_START


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _device_info(run: drivers.Run) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.profile is not None:
        info["busy_s"] = run.profile.busy_s
        info["window_s"] = run.profile.wall_s
    return info


def setup(cell, seed: int, trace: bool, device: torch.device):
    """The cell's driver with its pool made and every shape warmed up."""
    run = drivers.Run(cell=cell, seed=seed, device=device, trace=trace)
    drv = drivers.driver(run)
    drv.warm()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    return run, drv


def judge(drv, lowp: bool = False) -> dict:
    """The numbers compared, worst over the sampled units, of the
    program's outputs against the reference's; with lowp=True the control's
    instead: the reference in bfloat16 in the program's place."""
    refs = drv.reference()
    got = drv.reference(lowp=True) if lowp else drv.outputs()
    return drv.numbers(got, refs)


def execute(bench, cell, seed: int, seconds: float, trace: bool, device: torch.device) -> tuple:
    """Run the cell once: (result dict, [(name, value, limit)], notes)."""
    run, drv = setup(cell, seed, trace, device)
    run.setup_s = process_age_s()
    drv.window(seconds)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        if trace:
            drv.profile(bench.root)
    drv.release()
    correct, rows = check.verdict(judge(drv), cell.mix["limits"])

    metrics = {}
    for entry, read in bench.metrics(cell, trace):
        value = read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    units = sum(run.units.values())
    result = {"correct": bool(correct), "attempted": int(units), "failed": 0 if correct else len(drv.sample),
              "metrics": metrics, "device": _device_info(run)}
    if trace and run.profile is not None:
        result["breakdown"] = {"device_ops": [[n, s] for n, s in run.profile.device_ops],
                               "idle_gaps": [[n, s] for n, s in run.profile.idle_gaps]}
    notes = []
    if run.late_ms:
        notes.append({"generator_late_ms": {"p50": stats.percentile(run.late_ms, 50),
                                            "p95": stats.percentile(run.late_ms, 95),
                                            "max": max(run.late_ms)}, "frames": len(run.late_ms)})
    if device.type == "cuda":
        result["card"] = card_line()
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result, rows, notes


def emit(result: dict, rows: list, notes: list, out, err) -> None:
    """The notes and the result line on standard output, the numbers
    compared with their limits last on standard error."""
    for note in notes:
        print(json.dumps(note), file=out, flush=True)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'FAILED'}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
