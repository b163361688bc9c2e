"""bench_cuda.py, the port's benchmark entry point, on the CPU: its sections
called in-process through the plain PyTorch twins at small sizes, the
JSON lines they print (bench.py's metric names and fields, plus passes,
median, the baseline, the host CPU and the device), its integrity guard,
its refusal to run without a GPU, and its imports (neither JAX nor the JAX
package)."""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_cuda  # noqa: E402

torch.set_num_threads(2)
FIELDS = ("metric", "value", "unit", "baseline_fps", "baseline_source", "host_cpu", "device")


def _lines(capsys) -> dict:
    out = capsys.readouterr().out
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    return {rec["metric"]: rec for rec in lines}


def _check(rec: dict, timed: bool) -> None:
    for key in FIELDS:
        assert key in rec, key
    assert math.isfinite(rec["value"]) and rec["value"] >= 0
    assert rec["baseline_source"] in ("native_pm_g2", "literature_fallback")
    assert rec["baseline_fps"] > 0 and rec["device"] == {"name": "cpu", "power_limit": None}
    if timed:
        assert rec["value"] > 0 and len(rec["passes"]) >= 1
        assert rec["value"] == max(rec["passes"]) and min(rec["passes"]) <= rec["median"] <= rec["value"]


def test_headline_line(capsys):
    bench_cuda.bench_headline(device="cpu", batch=2, height=96, width=128, seeds=(0, 1), passes=2)
    lines = _lines(capsys)
    assert list(lines) == ["akaze_vga_detect_describe_match_fps"]
    rec = lines["akaze_vga_detect_describe_match_fps"]
    _check(rec, timed=True)
    assert rec["unit"] == "frames/s" and len(rec["passes"]) == 2
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / rec["baseline_fps"])


def test_headline_integrity_guard_fires_on_identical_sets():
    with pytest.raises(RuntimeError, match="identical"):
        bench_cuda.bench_headline(device="cpu", batch=2, height=96, width=128, seeds=(0, 0), passes=1)


def test_two_view_lines(capsys):
    bench_cuda.bench_two_view(device="cpu", pairs=2, height=96, width=128, seeds=(1, 2), reps=1, iterations=32)
    lines = _lines(capsys)
    assert list(lines) == ["two_view_pose_pairs_per_s", "two_view_rot_err_deg", "two_view_tdir_err_deg"]
    _check(lines["two_view_pose_pairs_per_s"], timed=True)
    for name, bound in (("two_view_rot_err_deg", 1.5), ("two_view_tdir_err_deg", 6.0)):
        rec = lines[name]
        _check(rec, timed=False)
        assert rec["unit"] == "deg" and rec["vs_baseline"] == pytest.approx(rec["value"] / bound)
        assert rec["value"] <= bound and rec["inliers"] >= 30  # the reference bound, on its draws


def test_sfm_lines(capsys):
    bench_cuda.bench_sfm(device="cpu", num_keyframes=8, num_points=120, passes=1)
    lines = _lines(capsys)
    assert list(lines) == ["sfm_8kf_keyframes_per_s", "sfm_8kf_ate"]
    _check(lines["sfm_8kf_keyframes_per_s"], timed=True)
    _check(lines["sfm_8kf_ate"], timed=False)
    assert lines["sfm_8kf_ate"]["value"] < 0.05  # tests/test_sfm.py's gate


# In a fresh interpreter: import bench_cuda, report the modules of JAX and
# of the JAX package that the import loaded, then run its main() with no
# arguments, as a user would run the script.
_FRESH = textwrap.dedent("""
    import json, sys
    import bench_cuda
    print("modules " + json.dumps(sorted(m for m in sys.modules
                                         if m.split(".")[0] in ("jax", "jaxlib", "akaze_tpu"))), flush=True)
    sys.argv = ["bench_cuda.py"]
    bench_cuda.main()
""")


@pytest.fixture(scope="module")
def fresh_run():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main() would run the benchmark")
    return subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_imports_neither_jax_nor_the_jax_package(fresh_run):
    report = [line for line in fresh_run.stdout.splitlines() if line.startswith("modules ")]
    assert report == ["modules []"], fresh_run.stdout + fresh_run.stderr


def test_main_refuses_to_run_without_a_gpu(fresh_run):
    assert fresh_run.returncode != 0 and "CUDA" in fresh_run.stderr
    assert not [line for line in fresh_run.stdout.splitlines() if line.startswith("{")]
