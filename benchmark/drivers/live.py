"""The entry "live": an open loop at `rate_hz`: at each due time one frame
from host memory through `extract`, `match_features` against the previous
frame, and features and matches read back to the host."""

from __future__ import annotations

import contextlib
import random
import time

import torch

from benchmark.harness import check, port, roofline, trace
from benchmark.harness.drivers import Driver, Run, sync
from benchmark.reference import akaze as ref_akaze
from benchmark.reference import match as ref_match


class LiveDriver(Driver):
    unit = "frames"

    def __init__(self, run: Run):
        super().__init__(run)
        self.per_call = 1
        self.prev = None

    def frame(self, j: int):
        S, T = self.pool.shape[0], self.pool.shape[1]
        return self.pool[(j // T) % S, j % T]

    def step(self, j: int):
        """Frame j from host memory to features and matches on the host."""
        dev = self.run.device
        self.stages.mark()
        feats = port.extract(self.frame(j), self.akaze, device=dev)
        self.stages.mark("extract")
        prev = self.prev if self.prev is not None else feats
        m = port.match_features(prev, feats, self.mcfg, device=dev)
        self.stages.mark("match")
        host = {k: v.to("cpu", non_blocking=True) for k, v in check.features_of(feats).items()}
        mh = {k: v.to("cpu", non_blocking=True) for k, v in check.matches_of(m).items()}
        sync(dev)
        self.prev = feats
        return host, mh

    def warm(self) -> None:
        for j in range(int(self.mix["warmup_frames"])):
            self.step(j)
        self.first = int(self.mix["warmup_frames"])

    def window(self, seconds: float) -> None:
        run = self.run
        period = 1.0 / float(self.mix["rate_hz"])
        n = int(seconds * float(self.mix["rate_hz"]))
        picks = set(random.Random(run.seed).sample(range(n), min(n, int(self.mix["sample_frames"]))))
        kept = []
        if run.trace:
            run.spans = port.SpanRecorder()
        self.stages.open()
        with port.record_spans(run.spans) if run.trace else contextlib.nullcontext():
            t0 = time.perf_counter()
            for k in range(n):
                due = t0 + k * period
                while time.perf_counter() < due:  # spin: a sleep wakes ~0.6 ms late
                    pass
                start = time.perf_counter()
                out = self.step(self.first + k)
                done = time.perf_counter()
                run.late_ms.append((start - due) * 1e3)
                run.latencies_ms.append((done - due) * 1e3)
                if k in picks:
                    kept.append((self.first + k, out))
            run.window_s = time.perf_counter() - t0
        self.stages.close()
        run.calls = n
        run.units = {"frames": n}
        self.sample = kept

    def profile(self, root) -> None:
        """The next `profile_frames` frames at the mix's rate; the window
        of the idle share is their own service time."""
        period = 1.0 / float(self.mix["rate_hz"])
        first = self.first + self.run.calls
        service = []

        def step(k):
            due = time.perf_counter() + period
            while time.perf_counter() < due:
                pass
            t = time.perf_counter()
            self.step(first + k)
            service.append(time.perf_counter() - t)

        self.run.profile = trace.profile(torch, step, int(self.mix["profile_frames"]), roofline.kernel_names(root))
        self.run.profile.service_s = sum(service)
        self.run.bounds_s = {}

    def reference(self, lowp: bool = False) -> list:
        """Features of each sampled frame and of the frame before it, and
        the matches between them."""
        js = [j for j, _ in self.sample]
        frames = torch.stack([self.frame(j - 1) for j in js] + [self.frame(j) for j in js]).to(self.run.device)
        f = ref_akaze.extract(frames, self.params, lowp=lowp)
        n = len(js)
        prev = {k: v[:n] for k, v in f.items()}
        cur = {k: v[n:] for k, v in f.items()}
        m = ref_match.match(prev["descriptors"], prev["valid"], cur["descriptors"], cur["valid"],
                            **self.match_opts)
        return [({k: v[q : q + 1] for k, v in cur.items()}, {k: v[q : q + 1] for k, v in m.items()})
                for q in range(n)]

    def outputs(self) -> list:
        return [({k: v[None] for k, v in f.items()}, {k: v[None] for k, v in m.items()}) for _, (f, m) in self.sample]


DRIVER = LiveDriver
