"""Spans, structured metrics and the NaN switch of the port (counterpart of
the JAX package's `akaze_tpu/utils/profiling.py`).

`span(name, device)` marks a region of a device path, in a `with`
statement:

    with span("frontend.detect", device):
        kps = detect(cand, fields, statics)

- On CUDA it is always an NVTX range, the view of an Nsight timeline (one
  C call on entry and one on exit).
- While torch.profiler runs, it is also a `torch.profiler.record_function`
  range: the span shows by name in the trace, on the profiler's host clock
  beside the device's events.  The profiler also projects the range onto
  the device's timeline as a user annotation, which is no device work.
- While a `SpanRecorder` is active (`record_spans`), the recorder keeps the
  span, its parent (the span open around it) and its host-clock times; on
  CUDA also a pair of CUDA events on the current stream, so that after one
  synchronization the caller reads the device time of every span.
- Otherwise it does nothing else: a span costs a flag check, makes no
  dispatcher call, records no event, allocates nothing and never syncs.

Names carry the layer: `frontend.*` (`frontend/pipeline.py`,
`kernels/fed.py`), `matching.*` (`matching/hamming.py`),
`geometry.*` (`geometry/twoview.py`), `sfm.*` (`sfm/incremental.py`) and
`linalg` (the `torch.linalg` calls of two-view and SfM).  A span opened
outside every other span is an entry span: the spans of one call of an
entry point are the spans below it.

`MetricsLogger` writes the CLIs' JSON-lines metrics.

`enable_debug_checks()` is the NaN switch of the entry points (extract,
video, two-view, SfM): while it is on, each checks its outputs and raises
`FloatingPointError` on a NaN (a host read per check); while it is off,
`check_no_nan` returns at once and reads nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass
class SpanRecord:
    """One span run under a recorder."""

    name: str
    parent: int | None  # index of the span open around it in `SpanRecorder.spans`; None for an entry span
    start_s: float  # host clock (time.perf_counter) at entry
    end_s: float = 0.0  # host clock at exit
    events: tuple | None = None  # CUDA (start, end) events on the stream; None off CUDA

    def ms(self) -> float:
        """Device ms between the span's events; 0 off CUDA."""
        return self.events[0].elapsed_time(self.events[1]) if self.events is not None else 0.0


class SpanRecorder:
    """The spans run while it is active (`record_spans`), in the order they
    opened (`spans`); `on_enter(name)`, if given, is called as each span
    opens (on any device).  Read the device times (`ms`, `self_ms`,
    `seconds`) after synchronizing the device."""

    def __init__(self, on_enter=None):
        self.spans: list[SpanRecord] = []
        self.on_enter = on_enter
        self._open: list[int] = []

    def _enter(self, name: str, cuda: bool) -> None:
        if self.on_enter is not None:
            self.on_enter(name)
        rec = SpanRecord(name, self._open[-1] if self._open else None, time.perf_counter())
        if cuda:
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        self._open.append(len(self.spans))
        self.spans.append(rec)

    def _exit(self) -> None:
        rec = self.spans[self._open.pop()]
        if rec.events is not None:
            rec.events[1].record()
        rec.end_s = time.perf_counter()

    def _timed(self, name: str) -> list:
        return [s for s in self.spans if s.name == name and s.events is not None]

    def count(self, name: str) -> int:
        """The spans of `name` timed by CUDA events."""
        return len(self._timed(name))

    def ms(self, name: str) -> float:
        """Device ms summed over the spans of `name`."""
        return sum(s.ms() for s in self._timed(name))

    def self_ms(self, name: str) -> float:
        """`ms(name)` less the device ms of the spans opened directly
        inside them."""
        inner: dict[int, float] = {}
        for s in self.spans:
            if s.parent is not None and s.events is not None:
                inner[s.parent] = inner.get(s.parent, 0.0) + s.ms()
        return sum(s.ms() - inner.get(i, 0.0) for i, s in enumerate(self.spans)
                   if s.name == name and s.events is not None)

    def seconds(self, name: str) -> float:
        """Seconds summed over the spans of `name`: device time where a span
        has CUDA events, the host clock where it has none."""
        return sum(s.ms() / 1e3 if s.events is not None else s.end_s - s.start_s
                   for s in self.spans if s.name == name)


_recorder: dict[str, SpanRecorder | None] = {"active": None}


@contextlib.contextmanager
def record_spans(recorder: SpanRecorder) -> Iterator[SpanRecorder]:
    """Make `recorder` receive the spans run inside the block."""
    previous, _recorder["active"] = _recorder["active"], recorder
    try:
        yield recorder
    finally:
        _recorder["active"] = previous


class _Span:
    """A span while a recorder or torch.profiler is on."""

    __slots__ = ("name", "cuda", "rec", "rf")

    def __init__(self, name: str, cuda: bool, rec: SpanRecorder | None):
        self.name, self.cuda, self.rec, self.rf = name, cuda, rec, None

    def __enter__(self) -> None:
        if self.cuda:
            torch.cuda.nvtx.range_push(self.name)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.rec is not None:
            self.rec._enter(self.name, self.cuda)

    def __exit__(self, *exc) -> None:
        if self.rec is not None:
            self.rec._exit()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.cuda:
            torch.cuda.nvtx.range_pop()


class _NvtxPop:
    """The exit of an NVTX range that `span` pushed (nothing else is on)."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        torch.cuda.nvtx.range_pop()


_NOTHING = contextlib.nullcontext()
_NVTX_POP = _NvtxPop()


def span(name: str, device: torch.device):
    """A named region of a device path, for a `with` statement (see the
    module's docstring); never a host sync."""
    rec = _recorder["active"]
    cuda = device.type == "cuda"
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        if not cuda:
            return _NOTHING
        torch.cuda.nvtx.range_push(name)
        return _NVTX_POP
    return _Span(name, cuda, rec)


class MetricsLogger:
    """Structured JSON-lines metrics (keypoints per frame, matches, frames/s)."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()


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
