"""The result line's schema, the numbers compared ending standard error,
and no result without a card."""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys

import torch

from benchmark.harness import runner
from benchmark.tests.conftest import ROOT, shrink


def test_result_line_schema(live_bench):
    bench = live_bench
    cell = shrink(bench.cell("tum_vga.live30hz"), rate_hz=10.0)
    result, rows, notes = runner.execute(bench, cell, 2**32 + 9, 0.5, False, torch.device("cpu"))
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "checks"
    assert result["correct"] is True and result["attempted"] == 5 and result["failed"] == 0
    assert set(result["metrics"]) == {"frame_latency_p95_ms", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(cell.mix["limits"])
    assert notes and "generator_late_ms" in notes[0]

    out, err = io.StringIO(), io.StringIO()
    runner.emit(result, rows, notes, out, err)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last == json.loads(json.dumps(result))
    tail = err.getvalue().strip().splitlines()[-len(rows):]
    assert all(line.startswith("check ") and line.endswith(" ok") for line in tail)


def test_no_result_without_a_card(tmp_path):
    cmd = [sys.executable, "benchmark/run.py", "--workload", "tum_vga.batch128", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
    # A checkout that holds only BENCHMARK.json and the benchmark's folder.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
