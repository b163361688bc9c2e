"""On the card: a small cell through the kernels against the reference and
the control, and no result where the program is missing.  Run them with
`python -m pytest -m gpu benchmark/tests` on a machine with a GPU; here
they skip."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest

from benchmark.harness import check, runner
from benchmark.tests.conftest import ROOT, shrink


@pytest.mark.gpu
def test_small_cell_on_the_card(bench, cuda_device):
    cell = shrink(bench.cell("kitti_gray.pairs32"))
    run, drv = runner.setup(cell, 2**33 + 17, False, cuda_device)
    drv.window(1.0)
    correct, rows = check.verdict(runner.judge(drv), cell.mix["limits"])
    assert correct and all(v == 0.0 for _, v, _ in rows), rows
    correct, rows = check.verdict(runner.judge(drv, lowp=True), cell.mix["limits"])
    assert not correct, rows


@pytest.mark.gpu
def test_no_result_without_the_program(cuda_device, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tum_vga.batch128", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cannot be imported" in out.stderr
