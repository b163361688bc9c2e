"""`correct` comes out false when the timed path is broken underneath, for
each fault a cell can have, and for the control (the reference in
bfloat16 in the program's place).  The runs skip the look for a card and
run the rest at a small size on the CPU."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from benchmark.harness import check, port, runner
from benchmark.tests.conftest import shrink


def _shift_x(feats, frame: int, dx: float = 0.5):
    kp = feats.keypoints
    x = kp.x.clone()
    x[frame] += dx
    return dataclasses.replace(feats, keypoints=dataclasses.replace(kp, x=x))


def _index(feats, idx):
    kp = feats.keypoints
    return dataclasses.replace(
        feats, descriptors=feats.descriptors[idx],
        keypoints=dataclasses.replace(kp, **{f.name: getattr(kp, f.name)[idx] for f in dataclasses.fields(kp)}))


def stale(fn):
    """A step that returns its state unchanged: each call hands back the
    previous call's answer."""
    last = {}

    def wrapped(frames, *a, **k):
        out = fn(frames, *a, **k)
        prev, last["out"] = last.get("out", out), out
        return prev
    return wrapped


def half_batch(fn):
    """Half of the batch left out: the first half's answers stand for all."""
    def wrapped(frames, *a, **k):
        half = max(1, frames.shape[0] // 2)
        out = fn(frames[:half], *a, **k)
        return _index(out, torch.arange(frames.shape[0]) % half)
    return wrapped


def altered_extract(fn):
    """An answer altered where it is produced: frame 0's keypoints moved."""
    return lambda frames, *a, **k: _shift_x(fn(frames, *a, **k), 0)


def coarsest_octave(fn):
    """A fault confined to one octave, as a tile plan or padding bug at the
    smallest shape would be: each frame's keypoints in its coarsest octave
    moved by half a pixel, every other keypoint left as it is."""
    def wrapped(frames, *a, **k):
        out = fn(frames, *a, **k)
        kp = out.keypoints
        octave = torch.where(kp.valid, kp.octave, -1)
        top = octave.amax(-1, keepdim=True)
        x = torch.where(kp.valid & (octave == top) & (top > 0), kp.x + 0.5, kp.x)
        return dataclasses.replace(out, keypoints=dataclasses.replace(kp, x=x))
    return wrapped


def altered_pose(fn):
    """An answer altered where it is produced: each rotation turned by 1 deg."""
    c, s = math.cos(math.radians(1.0)), math.sin(math.radians(1.0))

    def wrapped(*a, **k):
        res = fn(*a, **k)
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=res.R.dtype)
        return dataclasses.replace(res, R=turn @ res.R)
    return wrapped


def stale_frame(fn):
    """Each frame answered with the previous frame's features."""
    last = {}

    def wrapped(img, *a, **k):
        out = fn(img, *a, **k)
        prev, last["out"] = last.get("out", out), out
        return prev
    return wrapped


def altered_frame(fn):
    """Each frame's keypoints moved by half a pixel."""
    return lambda img, *a, **k: _shift_x(fn(img, *a, **k), slice(None))


FAULTS = [
    ("tum_vga.batch128", "extract_batch", stale),
    ("tum_vga.batch128", "extract_batch", half_batch),
    ("tum_vga.batch128", "extract_batch", altered_extract),
    ("tum_vga.batch128", "extract_batch", coarsest_octave),
    ("kitti_gray.batch128", "extract_batch", coarsest_octave),
    ("kitti_gray.pairs32", "extract_batch", half_batch),
    ("kitti_gray.pairs32", "estimate_relative_pose", altered_pose),
    ("tum_vga.live30hz", "extract", stale_frame),
    ("tum_vga.live30hz", "extract", altered_frame),
]


@pytest.mark.parametrize("cell_name,entry,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_fault_is_not_correct(live_bench, monkeypatch, cell_name, entry, fault):
    monkeypatch.setattr(port, entry, fault(getattr(port, entry)))
    cell = shrink(live_bench.cell(cell_name))
    result, rows, _ = runner.execute(live_bench, cell, 2**33 + 3, 0.6, False, torch.device("cpu"))
    assert result["correct"] is False, rows
    if fault is coarsest_octave:  # the octave reads whole, not as its few per cent of the frame
        assert result["checks"]["keypoints_off"]["value"] == 1.0, rows


@pytest.mark.parametrize("cell_name", ["tum_vga.batch128", "kitti_gray.pairs32", "tum_vga.live30hz"])
def test_control_is_not_correct(live_bench, cell_name):
    bench = live_bench
    cell = shrink(bench.cell(cell_name))
    run, drv = runner.setup(cell, 2**31 + 11, False, torch.device("cpu"))
    drv.window(0.6)
    correct, rows = check.verdict(runner.judge(drv), cell.mix["limits"])
    assert correct, rows
    correct, rows = check.verdict(runner.judge(drv, lowp=True), cell.mix["limits"])
    assert not correct, rows
