"""The metrics' arithmetic on made-up event lists and runs."""

from __future__ import annotations

import statistics
import types

import numpy as np
import pytest

from benchmark.harness import spec, stats, trace
from benchmark.tests.conftest import ROOT


def reader(name):
    return spec.load_reader(ROOT / "benchmark" / "metrics" / f"{name}.py")


def fake_run(**kw):
    base = dict(units={}, window_s=0.0, latencies_ms=[], stage_ms={}, spans=None, profile=None, bounds_s={},
                calls=0, setup_s=0.0, cell=types.SimpleNamespace(mix={"batch": 128}))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_rates_are_all_the_work_over_the_whole_window():
    assert stats.rate(1280, 0.5) == 2560.0
    assert stats.rate(0, 1.0) is None and stats.rate(5, 0.0) is None
    assert reader("frames_per_s")(fake_run(units={"frames": 3840}, window_s=1.5)) == 2560.0
    assert reader("pairs_per_s")(fake_run(units={"pairs": 96}, window_s=0.6)) == pytest.approx(160.0)
    assert reader("pairs_per_s")(fake_run(units={"frames": 96}, window_s=0.6)) is None


def test_p95_is_taken_over_every_frame():
    lat = [10.0] * 570 + [50.0] * 30  # 600 frames: the slowest 5 % are 50 ms
    assert stats.percentile(lat, 95) == pytest.approx(float(np.percentile(lat, 95)))
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 300, 601):
        v = rng.exponential(10.0, n).tolist()
        assert stats.percentile(v, 95) == pytest.approx(float(np.percentile(v, 95)))
    assert reader("frame_latency_p95_ms")(fake_run(latencies_ms=lat)) == pytest.approx(float(np.percentile(lat, 95)))
    assert stats.percentile([], 95) is None


def test_spread_is_the_quartile_distance_over_the_median():
    v = [100.0, 101.0, 99.0, 100.5, 98.0, 102.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_busy_time_is_the_union_of_device_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 10.5)]
    assert stats.union_s(iv) == pytest.approx(3.0 + 1.0 + 0.5)
    assert stats.gaps(iv) == [(3.0, 5.0), (6.0, 10.0)]
    assert stats.idle_pct(0.9, 1.2) == pytest.approx(25.0)
    assert stats.idle_pct(0.0, 1.0) is None


def test_idle_readers():
    prof = trace.Profile(wall_s=0.4, busy_s=0.3, device_ops=[], idle_gaps=[], kernel_s={}, service_s=0.32)
    assert reader("idle_pct.batch")(fake_run(profile=prof)) == pytest.approx(25.0)
    assert reader("idle_pct.pairs")(fake_run(profile=prof)) == pytest.approx(25.0)
    assert reader("idle_pct.live")(fake_run(profile=prof)) == pytest.approx(6.25)
    assert reader("idle_pct.batch")(fake_run()) is None


def test_roofline_reader_counts_only_kernels_that_ran():
    prof = trace.Profile(wall_s=1.0, busy_s=1.0, device_ops=[], idle_gaps=[],
                         kernel_s={"base_stage": 0.004, "fused_octave": 0.016})
    run = fake_run(profile=prof, bounds_s={"base_stage": 0.001, "fused_octave": 0.004, "describe": 0.5})
    assert reader("kernels_roofline")(run) == pytest.approx(25.0)
    assert reader("kernels_roofline")(fake_run(profile=prof)) is None


def test_stage_readers_divide_by_their_units():
    run = fake_run(stage_ms={"extract": [40.0, 44.0], "match": [0.508, 0.508], "ransac": [150.0, 160.0]})
    assert reader("extract_ms.batch")(run) == pytest.approx(84.0 / 256)
    assert reader("match_ms.batch")(run) == pytest.approx(1.016 / 254)
    assert reader("ransac_ms.pairs")(run) == pytest.approx(155.0)
    assert reader("extract_ms.live")(run) == pytest.approx(42.0)
    spans = types.SimpleNamespace(count=lambda name: 8, ms=lambda name: 260.0)
    assert reader("linalg_ms.pairs")(fake_run(spans=spans, calls=2)) == pytest.approx(130.0)
    assert reader("extract_ms.batch")(fake_run()) is None


def test_profile_names_and_gaps():
    assert trace.op_name("void level_diffuse_kernel<256>(float const*, float*, int)") == "void level_diffuse_kernel<256>"
    assert trace.op_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"
    cpu = [(0.0, 100.0, "bench.call"), (10.0, 20.0, "aten::topk"), (30.0, 40.0, "cudaStreamSynchronize")]
    starts = [c[0] for c in cpu]
    assert trace._host_range(cpu, starts, 15.0) == "aten::topk"
    assert trace._host_range(cpu, starts, 35.0) == "cudaStreamSynchronize"
    assert trace._host_range(cpu, starts, 50.0) == "bench.call"
    assert trace._host_range(cpu, starts, 150.0) == "host idle"
