"""Shared fixtures of the benchmark's own tests (CPU unless marked gpu)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Sizes a CPU test run can hold: 120x160 frames, a few per call.
TINY = {"batch": 4, "sequences": 2, "sequence_frames": 8, "pairs": 2, "score_sets": 2, "warmup_calls": 1,
        "warmup_frames": 2, "sample_calls": 2, "sample_frames": 3, "profile_calls": 1, "profile_frames": 2}


def shrink(cell, rate_hz: float = 5.0):
    """The cell at a size the CPU runs in seconds (the same code paths)."""
    cell.config["camera"].update(width=160, height=120)
    for key, value in TINY.items():
        if key in cell.mix:
            cell.mix[key] = value
    if "ransac" in cell.mix:
        cell.mix["ransac"]["num_iterations"] = 64
    if "rate_hz" in cell.mix:
        cell.mix["rate_hz"] = rate_hz
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


#: The entries that would add the live cell (`traffic/live30hz.json`, the
#: "live" driver and its metric readers are in the benchmark's folder; the
#: cell is not in BENCHMARK.json while its p95 spreads with the host).
LIVE_ENTRIES = {
    "workloads": [{"name": "tum_vga.live30hz", "config": "tum_vga", "traffic": "live30hz", "chips": 1,
                   "why": "a live VO front end at 30 Hz"}],
    "end_to_end": [{"name": "frame_latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": ["tum_vga.live30hz"]}],
    "per_layer": [{"name": "extract_ms.live", "unit": "ms/frame", "better": "lower", "source": "program_span",
                   "layer": "frontend.pipeline", "moves": "frame_latency_p95_ms", "workloads": ["tum_vga.live30hz"]},
                  {"name": "idle_pct.live", "unit": "%", "better": "lower", "source": "device_trace",
                   "layer": "device", "moves": "frame_latency_p95_ms", "workloads": ["tum_vga.live30hz"]}],
}


@pytest.fixture
def bench():
    from benchmark.harness import spec

    return spec.Bench.load(ROOT)


@pytest.fixture
def live_bench():
    """BENCHMARK.json with the live cell's entries added, as a later PR
    would add them: no file of the benchmark changes."""
    from benchmark.harness import spec

    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for group, entries in LIVE_ENTRIES.items():
        data[group] = data[group] + [dict(e) for e in entries]
    setup = next(m for m in data["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup
    return spec.Bench(data, ROOT / "benchmark", ROOT)


@pytest.fixture
def cuda_device():
    """The first GPU; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
