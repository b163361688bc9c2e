"""Stage timing, structured metrics and profiler traces of the port
(counterpart of the JAX package's `akaze_tpu/utils/profiling.py`).

`StageTimer` brackets each stage with a synchronization of its device
(`torch.cuda.synchronize` on CUDA), a `torch.profiler.record_function`
range and, on CUDA, an NVTX range, so a stage shows by name in a
torch.profiler trace and in an NVTX timeline.
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
