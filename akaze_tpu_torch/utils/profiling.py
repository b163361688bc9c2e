"""Stage timing, structured metrics and profiler traces of the port
(counterpart of the JAX package's `akaze_tpu/utils/profiling.py`).

`StageTimer` brackets each stage with a synchronization of its device
(`torch.cuda.synchronize` on CUDA), a `torch.profiler.record_function`
range and, on CUDA, an NVTX range, so a stage shows by name in a
torch.profiler trace and in an NVTX timeline.

`span(name, device)` marks a region of a device path the same way without
a sync; while a `SpanRecorder` is active (`record_spans`), each span also
records a pair of CUDA events on the current stream, so a caller can read
the device time of every span after one synchronization.  The SfM stack
marks its window super-steps (`sfm.window`), bundle adjustments (`sfm.ba`),
pose graphs (`sfm.pose_graph`) and `torch.linalg` calls (`linalg`).

`enable_debug_checks()` is the NaN switch of the entry points (extract,
video, two-view, SfM): while it is on, each checks its outputs and raises
`FloatingPointError` on a NaN (a host read per check); while it is off,
`check_no_nan` returns at once and reads nothing.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Iterator

import torch

logger = logging.getLogger("akaze_tpu_torch")


class StageTimer:
    """Wall-clock time per stage, with device-sync boundaries.

        timer = StageTimer(device="cuda")
        with timer.stage("extract"):
            feats = extract_batch(frames)
        timer.summary()  # {"extract": seconds, ...}
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        cuda = self.device.type == "cuda"
        self._sync()
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()
        self._sync()
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        logger.debug("stage %s: %.4fs", name, dt)

    def summary(self) -> dict[str, float]:
        return dict(self.times)


class SpanRecorder:
    """The CUDA-event pairs of the spans run while it is active
    (`record_spans`), by name; `on_enter(name)`, if given, is called as each
    span opens (on any device).  Read `ms` after synchronizing the device."""

    def __init__(self, on_enter=None):
        self.events: dict[str, list] = {}
        self.on_enter = on_enter

    def count(self, name: str) -> int:
        return len(self.events.get(name, ()))

    def ms(self, name: str) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events.get(name, ()))


_recorder: dict[str, SpanRecorder | None] = {"active": None}


@contextlib.contextmanager
def record_spans(recorder: SpanRecorder) -> Iterator[SpanRecorder]:
    """Make `recorder` receive the spans run inside the block."""
    previous, _recorder["active"] = _recorder["active"], recorder
    try:
        yield recorder
    finally:
        _recorder["active"] = previous


@contextlib.contextmanager
def span(name: str, device: torch.device) -> Iterator[None]:
    """A named region without a host sync: a `record_function` range, an
    NVTX range on CUDA, and CUDA events while a recorder is active."""
    rec = _recorder["active"]
    cuda = device.type == "cuda"
    if rec is not None and rec.on_enter is not None:
        rec.on_enter(name)
    events = None
    if cuda:
        torch.cuda.nvtx.range_push(name)
        if rec is not None:
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if cuda:
            if events is not None:
                events[1].record()
                rec.events.setdefault(name, []).append(events)
            torch.cuda.nvtx.range_pop()


class MetricsLogger:
    """Structured JSON-lines metrics (keypoints per frame, matches, frames/s)."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()


@contextlib.contextmanager
def profiler_trace(logdir: str | None) -> Iterator[None]:
    """torch.profiler around a region (host ops, and the card's kernels
    where CUDA is available), written as a Chrome trace to
    `logdir/trace.json`; no-op when logdir is empty."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_debug_checks = {"on": False}


def enable_debug_checks(enabled: bool = True) -> None:
    """Turn the entry points' NaN checks on (or off with enabled=False)."""
    _debug_checks["on"] = bool(enabled)


def debug_checks_enabled() -> bool:
    return _debug_checks["on"]


def check_no_nan(what: str, *tensors) -> None:
    """While debug checks are on, raise FloatingPointError if a floating
    tensor among `tensors` holds a NaN; otherwise do nothing (no host sync)."""
    if not _debug_checks["on"]:
        return
    for i, t in enumerate(tensors):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"{what}: NaN in output {i}")
