"""The reduction of a profiled slice by program span, on made-up intervals,
and the span readers on a made-up recorder."""

from __future__ import annotations

import types

import pytest

from benchmark.harness import spans
from benchmark.tests.conftest import ROOT
from benchmark.tests.test_harness_stats import fake_run, reader


def test_gaps_and_operations_go_to_the_innermost_span():
    # One call: extract (0-100) holds scale_space (0-40) holds contrast
    # (10-20), then candidates (50-90); the loop runs outside after 100.
    marks = [(0.0, 100.0, "frontend.extract"), (0.0, 40.0, "frontend.scale_space"),
             (10.0, 20.0, "frontend.contrast"), (50.0, 90.0, "frontend.candidates")]
    ops = [(1.0, 5.0, 1),  # launched in scale_space at 0.5
           (9.0, 11.0, 2),  # launched in contrast at 15
           (31.0, 55.0, 3),  # launched in candidates at 60
           (70.0, 80.0, 4),  # no runtime call linked
           (120.0, 130.0, 5)]  # launched outside at 101
    launch_at = {1: 0.5, 2: 15.0, 3: 60.0, 5: 101.0}
    rows = {r[0]: r[1:] for r in spans.by_span(ops, marks, launch_at)}
    # Gaps: 5-9 (mid 7, scale_space), 11-31 (mid 21, scale_space: contrast
    # ended at 20), 55-70 (mid 62.5, candidates), 80-120 (mid 100, extract
    # still open at its end).
    assert rows["frontend.scale_space"][0] == pytest.approx(24e-6)
    assert rows["frontend.candidates"][0] == pytest.approx(15e-6)
    assert rows["frontend.extract"][0] == pytest.approx(40e-6)
    assert rows["frontend.contrast"][:2] == [0.0, 1]
    assert rows["frontend.scale_space"][1:] == [1, pytest.approx(4e-6)]
    assert rows["frontend.candidates"][1:] == [1, pytest.approx(24e-6)]
    assert rows[spans.UNLINKED] == [0.0, 1, pytest.approx(10e-6)]
    assert rows[spans.OUTSIDE] == [0.0, 1, pytest.approx(10e-6)]
    assert sum(r[1] for r in rows.values()) == len(ops)
    assert [r[0] for r in spans.by_span(ops, marks, launch_at)][0] == "frontend.extract"  # most idle first


def test_a_gap_outside_every_span_is_the_loops():
    marks = [(10.0, 20.0, "frontend.extract")]
    ops = [(11.0, 12.0, 1), (40.0, 41.0, 2)]
    rows = {r[0]: r[1:] for r in spans.by_span(ops, marks, {1: 10.5, 2: 30.0})}
    assert rows[spans.OUTSIDE] == [pytest.approx(28e-6), 1, pytest.approx(1e-6)]
    assert rows["frontend.extract"] == [0.0, 1, pytest.approx(1e-6)]
    assert spans.innermost([], [], 5.0) == spans.OUTSIDE


def test_profiler_events_split_into_operations_spans_and_launches():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, a, b, device, eid, annotation=False):
        return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                     device_type=device, id=eid, is_user_annotation=annotation)

    events = [ev("frontend.detect", 0, 50, cpu, 900, True),
              ev("frontend.detect", 2, 60, cuda, 901, True),  # its projection on the device: no work
              ev("cudaLaunchKernel", 5, 6, cpu, 7), ev("aten::topk", 4, 7, cpu, 7),
              ev("void topk_kernel<float>(float const*)", 10, 20, cuda, 7),
              ev("Memset (Device)", 21, 22, cuda, 8)]
    ops, marks, launch_at = spans.of_events(torch, events)
    assert ops == [(10, 20, 7), (21, 22, 8)]
    assert marks == [(0, 50, "frontend.detect")]
    assert launch_at == {7: 5}
    rows = {r[0]: r[1:] for r in spans.by_span(ops, marks, launch_at)}
    assert rows["frontend.detect"][1] == 1 and rows[spans.UNLINKED][1] == 1


def test_span_readers_report_per_frame_and_per_call_and_skip_a_program_without_the_spans():
    ms = {"frontend.upload": 2.56, "frontend.scale_space": 12.8, "frontend.contrast": 6.4,
          "geometry.hypotheses": 30.0, "geometry.refit": 120.0}
    rec = types.SimpleNamespace(count=lambda n: 2 if n in ms else 0, ms=lambda n: ms.get(n, 0.0),
                                self_ms=lambda n: ms[n] - (ms["frontend.contrast"] if n == "frontend.scale_space" else 0))
    run = fake_run(spans=rec, calls=2)
    assert reader("upload_ms.batch")(run) == pytest.approx(0.01)
    assert reader("scale_space_ms.batch")(run) == pytest.approx(0.025)
    assert reader("contrast_ms.batch")(run) == pytest.approx(0.025)
    assert reader("hypotheses_ms.pairs")(run) == pytest.approx(15.0)
    assert reader("refit_ms.pairs")(run) == pytest.approx(60.0)
    for name in ("candidates_ms.batch", "detect_ms.batch", "describe_ms.batch"):
        assert reader(name)(run) is None
    # A program whose recorder has no such spans (and no self_ms), or an untraced run.
    older = types.SimpleNamespace(count=lambda n: 0, ms=lambda n: 0.0)
    for path in sorted((ROOT / "benchmark" / "metrics").glob("*_ms.*.py")):
        if path.stem not in ("extract_ms.batch", "extract_ms.live", "match_ms.batch", "ransac_ms.pairs"):
            assert reader(path.stem)(fake_run(spans=older, calls=2)) is None, path.stem
            assert reader(path.stem)(fake_run(calls=2)) is None, path.stem
