"""The general generator of the benchmark's traffic: a mix's pool of
synthetic camera sequences and its random draws, made from the seed on the
device in a few large calls.

A traffic mix is a JSON file beside this one (`<mix>.json`) of parameters
only: its "entry" names the driver of its loop (`benchmark/drivers/`), its
"scene" the maker of its frames (`benchmark/scenes/<scene>.py`, a function
`sequence(mix, frames, height, width, generator, device)` that returns uint8
(T, H, W)), and the rest are the counts and sizes that those and `pool`
read.  Frames are quantised to the camera's 8 bits.
"""

from __future__ import annotations

from pathlib import Path

import torch

from benchmark.harness.spec import BENCH_DIR, load_file

SCENES_DIR = BENCH_DIR / "scenes"


def pool(mix: dict, camera: dict, seed: int, device, scenes: Path = SCENES_DIR) -> torch.Tensor:
    """The mix's pool of `sequences` distinct sequences of `sequence_frames`
    frames of its scene at the camera's size: uint8 (S, T, H, W), made on
    `device` from `seed` and held in pinned host memory where the device is
    a GPU."""
    sequence = load_file("scene", Path(scenes) / f"{mix['scene']}.py", "sequence")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    S, T = int(mix["sequences"]), int(mix["sequence_frames"])
    H, W = int(camera["height"]), int(camera["width"])
    host = torch.empty((S, T, H, W), dtype=torch.uint8, pin_memory=torch.device(device).type == "cuda")
    for s in range(S):
        host[s].copy_(sequence(mix, T, H, W, gen, device))
    return host


def draws(mix: dict, capacity: int, seed: int, device) -> torch.Tensor | None:
    """The RANSAC's random scores of a mix that estimates poses: (n_sets,
    pairs, iterations, capacity) float32 on `device`, used in turn; None
    for a mix without a RANSAC."""
    if "ransac" not in mix:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 0x5EED) % (1 << 63))
    shape = (int(mix["score_sets"]), int(mix["pairs"]), int(mix["ransac"]["num_iterations"]), capacity)
    return torch.rand(shape, generator=gen, device=device)
