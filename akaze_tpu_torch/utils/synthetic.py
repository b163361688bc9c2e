"""Deterministic synthetic scenes (own copy of the JAX package's
`textured_scene` and `video_sequence`, numpy only).  Same seed, same pixels
as the reference, so the two packages can be fed identical frames."""

from __future__ import annotations

import numpy as np


def textured_scene(height: int = 480, width: int = 640, seed: int = 0) -> np.ndarray:
    """float32 (H, W) image in [0, 1] with multi-scale structure: smooth
    gradients, Gaussian blobs, a warped two-scale checkerboard and
    band-limited noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = 0.3 + 0.2 * np.sin(2 * np.pi * x / width) * np.cos(2 * np.pi * y / height)

    n_blobs = max(20, width * height // 4000)
    for _ in range(n_blobs):
        cx = rng.uniform(0.05, 0.95) * width
        cy = rng.uniform(0.05, 0.95) * height
        s = rng.uniform(1.5, 20.0)
        a = rng.uniform(-0.5, 0.5)
        img += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))

    u = x / width * 16 + 0.7 * np.sin(2 * np.pi * y / height * 2)
    v = y / height * 12 + 0.7 * np.sin(2 * np.pi * x / width * 3)
    img += 0.25 * ((np.floor(u) + np.floor(v)) % 2 - 0.5)
    img += 0.12 * ((np.floor(u * 3.7) + np.floor(v * 3.1)) % 2 - 0.5)

    coarse = rng.normal(0.0, 1.0, (height // 8 + 1, width // 8 + 1)).astype(np.float32)
    noise = np.kron(coarse, np.ones((8, 8), dtype=np.float32))[:height, :width]
    img += 0.03 * noise

    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def video_sequence(
    num_frames: int, height: int = 480, width: int = 640, seed: int = 0
) -> np.ndarray:
    """Synthetic panning video: float32 (T, H, W) crops of one textured
    scene twice the frame size."""
    base = textured_scene(height * 2, width * 2, seed=seed)
    frames = np.zeros((num_frames, height, width), dtype=np.float32)
    for t in range(num_frames):
        ox = int(width / 2 + 40 * np.sin(2 * np.pi * t / max(num_frames, 2)))
        oy = int(height / 2 + 25 * np.cos(2 * np.pi * t / max(num_frames, 2)))
        frames[t] = base[oy : oy + height, ox : ox + width]
    return frames
