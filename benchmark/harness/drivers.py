"""What every driver of a traffic mix shares, and the lookup of a mix's
driver by its "entry": `benchmark/drivers/<entry>.py`, whose `DRIVER` is a
subclass of `Driver`.  A driver sets a cell up (the mix's pool of frames,
its random draws, the warm-up of every shape the window uses), runs the
timed window, profiles a short slice, and hands the sampled outputs of the
window and the reference's outputs on the same inputs to `check`.

The run record (`Run`) is what the metric readers read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import torch

from benchmark.harness import check, port, roofline, spec, trace
from benchmark.reference import akaze as ref_akaze
from benchmark.traffic import generator


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers take their numbers here."""

    cell: object
    seed: int
    device: torch.device
    trace: bool = False
    setup_s: float = 0.0
    window_s: float = 0.0
    units: dict = dataclasses.field(default_factory=dict)  # {"frames": n} / {"pairs": n}
    calls: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    late_ms: list = dataclasses.field(default_factory=list)
    stage_ms: dict = dataclasses.field(default_factory=dict)  # {stage: [ms per call]} (trace)
    spans: object = None  # the port's SpanRecorder over the window (trace)
    profile: object = None  # trace.Profile of the steady slice (trace)
    bounds_s: dict = dataclasses.field(default_factory=dict)  # {kernel: s} over the slice
    memory_peak_bytes: int = 0


class Reservoir:
    """A uniform sample of k items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Stages:
    """CUDA events around a call's stages in a traced run; nothing otherwise."""

    def __init__(self, run: Run):
        self.on = False  # set while a traced run's window is open
        self.run, self.events = run, []

    def mark(self, stage: str | None = None) -> None:
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append((stage, e))

    def close(self) -> None:
        """Add each stage's ms to the run (reads the events: call after a
        sync) and stop marking."""
        for (_, a), (stage, b) in zip(self.events, self.events[1:]):
            if stage is not None:
                self.run.stage_ms.setdefault(stage, []).append(a.elapsed_time(b))
        self.events, self.on = [], False

    def open(self) -> None:
        self.on = self.run.trace and self.run.device.type == "cuda"


class Driver:
    def __init__(self, run: Run):
        self.run = run
        cell = run.cell
        self.mix, self.camera = cell.mix, cell.config["camera"]
        self.akaze, self.mcfg, self.rcfg = port.configs(cell.config, self.mix)
        self.params = ref_akaze.Params.of(cell.config["akaze"])
        self.match_opts = dict(cell.config["match"])
        self.pool = generator.pool(self.mix, self.camera, run.seed, run.device, cell.dir / "scenes")
        self.stages = _Stages(run)

    def step(self, i: int):
        """Call i of the mix on the program; returns what the sample keeps."""
        raise NotImplementedError

    def warm(self) -> None:
        """Every shape of the window, with as many outputs held as the
        window's sample holds, so that the allocator has grown before it."""
        held = []
        for i in range(int(self.mix["warmup_calls"])):
            held = (held + [self.step(-1 - i)])[-int(self.mix["sample_calls"]):]
        sync(self.run.device)

    def window(self, seconds: float) -> None:
        run = self.run
        sample = Reservoir(int(self.mix["sample_calls"]), run.seed)
        if run.trace:
            run.spans = port.SpanRecorder()
        self.stages.open()
        with port.record_spans(run.spans) if run.trace else contextlib.nullcontext():
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() - t0 < seconds:
                sample.offer((i, self.step(i)))
                i += 1
            sync(run.device)
            run.window_s = time.perf_counter() - t0
        self.stages.close()
        run.calls = i
        run.units = {self.unit: i * self.per_call}
        self.sample = sample.items

    def profile(self, root) -> None:
        """Profile the next `profile_calls` calls; their kernels' bounds
        come from their own outputs."""
        n = int(self.mix["profile_calls"])
        first, counts = self.run.calls, []

        def step(i):
            feats = self.step(first + i)[0]
            counts.append((feats["valid"].sum(-1), feats["valid"].shape[-1], feats["descriptors"].shape[-1]))

        self.run.profile = trace.profile(torch, step, n, roofline.kernel_names(root))
        bounds = {}
        for valid, slots, words in counts:
            for kernel, s in self.bounds(valid.cpu().tolist(), slots, words).items():
                bounds[kernel] = bounds.get(kernel, 0.0) + s
        self.run.bounds_s = bounds

    def bounds(self, valid: list, slots: int, words: int) -> dict:
        """{kernel: least seconds} of one call of kernels 1-4, from its
        frames' valid keypoint counts, the slots per frame and the
        descriptor words per slot."""
        st = ref_akaze.Statics(self.camera["width"], self.camera["height"], self.params)
        B = len(valid)
        va, vb = self.pairs_of(valid)
        return {
            "base_stage": roofline.base_stage(B, st.h0, st.w0),
            "fused_octave": roofline.fused_octave(B, st.groups, [len(lv.taus) for lv in st.levels]),
            "describe": roofline.describe(sum(valid), B * slots),
            "match": roofline.match(slots, slots, words, va, vb),
        }

    def numbers(self, outputs: list, refs: list) -> dict:
        per = {"keypoints_off": [], "descriptor_bits_off": [], "matches_off": []}
        for got, ref in zip(outputs, refs):
            kp, desc = check.features_off(got[0], ref[0])
            per["keypoints_off"] += kp
            per["descriptor_bits_off"] += desc
            per["matches_off"] += check.matches_off(got[1], ref[1])
        return check.worst(per)

    def outputs(self) -> list:
        return [out for _, out in self.sample]

    def release(self) -> None:
        """Drop what the program's window left on the device."""
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()


def driver(run: Run) -> Driver:
    """The driver that the cell's mix names by its "entry"."""
    cell = run.cell
    return spec.load_file("driver", cell.dir / "drivers" / f"{cell.mix['entry']}.py", "DRIVER")(run)
