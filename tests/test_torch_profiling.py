"""The port's spans (`utils.profiling`): what a recorder sees of
`extract_batch`, `match` and `estimate_relative_pose` (order and parents),
that a span with no recorder and no profiler on makes no dispatcher call
and records no CUDA event, the span names in a torch.profiler trace, the
recorder's device and self times, and on the card the front end's stage
spans against the whole extract.  The file imports no JAX; its card test
runs with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_profiling.py
"""

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, RansacConfig
from akaze_tpu_torch.frontend.pipeline import extract_batch
from akaze_tpu_torch.geometry.twoview import estimate_relative_pose
from akaze_tpu_torch.matching.hamming import match
from akaze_tpu_torch.utils import profiling
from akaze_tpu_torch.utils.profiling import SpanRecord, SpanRecorder, record_spans, span
from akaze_tpu_torch.utils.synthetic import video_sequence
from torch_port_helpers import cuda  # noqa: F401 (a fixture)

CPU = torch.device("cpu")
FRONT = ["frontend.extract", "frontend.upload", "frontend.scale_space", "frontend.contrast",
         "frontend.candidates", "frontend.detect", "frontend.describe"]
MATCHING = ["matching.match", "matching.reduce", "matching.filter"]
# Each refit round's torch.linalg calls, then the pose's.
TWOVIEW = ["geometry.twoview", "geometry.hypotheses", "geometry.refit", "linalg", "linalg", "linalg",
           "geometry.pose", "linalg"]
PARENT = {"frontend.upload": "frontend.extract", "frontend.scale_space": "frontend.extract",
          "frontend.contrast": "frontend.scale_space", "frontend.candidates": "frontend.extract",
          "frontend.detect": "frontend.extract", "frontend.describe": "frontend.extract",
          "matching.reduce": "matching.match", "matching.filter": "matching.match",
          "geometry.hypotheses": "geometry.twoview", "geometry.refit": "geometry.twoview",
          "geometry.pose": "geometry.twoview"}
# The six stages of the front end's metrics, which together make up the
# whole extract: scale_space less its contrast factor, and the rest.
STAGES = ["frontend.upload", "frontend.scale_space", "frontend.candidates", "frontend.detect",
          "frontend.describe"]


def _calls(device=CPU):
    """extract_batch on two small uint8 frames, match, a small RANSAC."""
    frames = (video_sequence(2, 120, 160, seed=3) * 255).astype(np.uint8)
    feats = extract_batch(frames, AkazeConfig(num_octaves=3, max_keypoints=128, detector_threshold=1e-4),
                          device=device)
    d, v = feats.descriptors, feats.keypoints.valid
    match(d[:1], v[:1], d[1:], v[1:], MatchConfig(), device=device)
    g = torch.Generator().manual_seed(0)
    x1 = torch.cat([torch.rand(32, 2, generator=g), torch.ones(32, 1)], 1)
    x2 = x1 + 0.01 * torch.rand(32, 3, generator=g)
    estimate_relative_pose(x1, x2, torch.ones(32, dtype=torch.bool), RansacConfig(num_iterations=16, refit_beam=2),
                           device=device)


def test_a_recorder_sees_the_stages_in_order_with_their_parents():
    with record_spans(SpanRecorder()) as rec:
        _calls()
    names = [s.name for s in rec.spans]
    assert names == FRONT + MATCHING + TWOVIEW
    parent = [rec.spans[s.parent].name if s.parent is not None else None for s in rec.spans]
    for name, up in zip(names, parent):
        if name == "linalg":
            assert up in ("geometry.refit", "geometry.pose")
        else:
            assert up == PARENT.get(name), name
    # Entry spans: one per call of an entry point.
    assert [s.name for s in rec.spans if s.parent is None] == ["frontend.extract", "matching.match",
                                                               "geometry.twoview"]
    assert all(s.end_s >= s.start_s and s.events is None for s in rec.spans)
    assert rec.count("frontend.extract") == 0 and rec.ms("frontend.extract") == 0.0  # CUDA events only on the card
    assert rec.seconds("frontend.extract") >= rec.seconds("frontend.detect") > 0  # the host clock off the card


def test_a_span_that_raises_closes():
    with record_spans(SpanRecorder()) as rec:
        with pytest.raises(ValueError):
            with span("outer", CPU), span("inner", CPU):
                raise ValueError
        with span("after", CPU):
            pass
    assert [(s.name, s.parent) for s in rec.spans] == [("outer", None), ("inner", 0), ("after", None)]
    assert profiling._recorder["active"] is None


def test_spans_off_make_no_dispatcher_call_and_record_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _calls()
    # On CUDA only the NVTX range remains, and nothing is allocated per span.
    nvtx = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: nvtx.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: nvtx.append(("pop",)))
    gpu = torch.device("cuda", 0)
    with span("frontend.detect", gpu):
        with span("frontend.describe", gpu):
            pass
    assert nvtx == [("push", "frontend.detect"), ("push", "frontend.describe"), ("pop",), ("pop",)]
    assert span("a", CPU) is span("b", CPU) and span("a", gpu) is span("b", gpu)


def test_span_names_show_under_torch_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _calls()
    traced = {e.key for e in prof.key_averages()}
    assert set(FRONT + MATCHING + TWOVIEW) <= traced


class _Event:
    """A CUDA event's stand-in: elapsed_time is the difference of stamps."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_time_and_self_time_of_nested_spans():
    rec = SpanRecorder()
    ev = lambda a, b: (_Event(a), _Event(b))  # noqa: E731
    rec.spans = [SpanRecord("frontend.extract", None, 0.0, 1.0, ev(0.0, 10.0)),
                 SpanRecord("frontend.scale_space", 0, 0.0, 1.0, ev(1.0, 5.0)),
                 SpanRecord("frontend.contrast", 1, 0.0, 1.0, ev(2.0, 3.5)),
                 SpanRecord("frontend.detect", 0, 0.0, 1.0, ev(6.0, 9.0)),
                 SpanRecord("frontend.extract", None, 0.0, 1.0, ev(20.0, 22.0)),
                 SpanRecord("tracks", None, 2.0, 2.25)]
    assert rec.ms("frontend.extract") == 12.0 and rec.count("frontend.extract") == 2
    assert rec.self_ms("frontend.extract") == 12.0 - 4.0 - 3.0
    assert rec.self_ms("frontend.scale_space") == 4.0 - 1.5
    assert rec.self_ms("frontend.contrast") == rec.ms("frontend.contrast") == 1.5
    assert rec.count("tracks") == 0 and rec.ms("tracks") == 0.0 and rec.seconds("tracks") == 0.25
    assert rec.seconds("frontend.extract") == pytest.approx(0.012)


@pytest.mark.gpu
def test_stage_spans_make_up_the_extract_on_the_card(cuda):  # noqa: F811
    frames = (video_sequence(16, 480, 640, seed=1) * 255).astype(np.uint8)
    extract_batch(frames, device=cuda)  # builds and loads the kernels
    torch.cuda.synchronize(cuda)
    with record_spans(SpanRecorder()) as rec:
        for _ in range(2):
            extract_batch(frames, device=cuda)
    torch.cuda.synchronize(cuda)
    assert all(rec.count(name) == 2 for name in FRONT)
    whole = rec.ms("frontend.extract")
    assert sum(rec.ms(name) for name in STAGES) == pytest.approx(whole, rel=0.03)
    assert rec.self_ms("frontend.scale_space") == pytest.approx(
        rec.ms("frontend.scale_space") - rec.ms("frontend.contrast"), rel=1e-6, abs=1e-6)
    assert 0 < rec.ms("frontend.contrast") < rec.ms("frontend.scale_space") < whole
