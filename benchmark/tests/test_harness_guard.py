"""The import guard compares whole top-level names, and a run's process
loads neither JAX nor the JAX package."""

from __future__ import annotations

import subprocess
import sys

from benchmark.harness import guard
from benchmark.tests.conftest import ROOT


def test_whole_top_level_names():
    assert guard.forbidden_modules({"akaze_tpu_torch": 1, "akaze_tpu_torch.frontend.pipeline": 1}) == []
    assert guard.forbidden_modules({"akaze_tpu.core.config": 1, "numpy": 1}) == ["akaze_tpu"]
    assert guard.forbidden_modules({"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1}) == ["flax", "jax", "jaxlib"]
    assert guard.forbidden_modules({"jaxtyping": 1, "akaze_tpu_tools": 1}) == []


def test_a_run_loads_no_jax():
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
torch.set_num_threads(2)
from benchmark.harness import guard, runner, spec
from benchmark.tests.conftest import shrink
bench = spec.Bench.load({str(ROOT)!r})
for name in ("tum_vga.batch128", "kitti_gray.pairs32"):
    result, _, _ = runner.execute(bench, shrink(bench.cell(name)), 3, 0.3, False, torch.device("cpu"))
    assert result["correct"]
print("FOUND", guard.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
