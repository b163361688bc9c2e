"""Match visualization: side-by-side image with keypoint marks and match
lines (own copy of the JAX package's `akaze_tpu/cli/viz.py`).

Pure NumPy rendering, written as binary PGM (or any PIL-supported format if
PIL is present) — no plotting dependencies.
"""

from __future__ import annotations

import pathlib

import numpy as np


def _draw_line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float,
               value: float) -> None:
    """Sampled line segment (dense enough for display)."""
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    t = np.linspace(0.0, 1.0, n)
    xs = np.clip(np.round(x0 + (x1 - x0) * t).astype(int), 0, img.shape[1] - 1)
    ys = np.clip(np.round(y0 + (y1 - y0) * t).astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = value


def _draw_circle(img: np.ndarray, x: float, y: float, r: float, value: float) -> None:
    n = max(int(2 * np.pi * max(r, 1)), 8)
    t = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    xs = np.clip(np.round(x + r * np.cos(t)).astype(int), 0, img.shape[1] - 1)
    ys = np.clip(np.round(y + r * np.sin(t)).astype(int), 0, img.shape[0] - 1)
    img[ys, xs] = value


def render_matches(
    img_a: np.ndarray, img_b: np.ndarray,
    xa: np.ndarray, ya: np.ndarray, sa: np.ndarray,
    xb: np.ndarray, yb: np.ndarray, sb: np.ndarray,
    pairs: np.ndarray,
) -> np.ndarray:
    """Side-by-side canvas with keypoint circles and match lines.

    pairs: (M, 2) indices into the a/b keypoint arrays.  Returns float32
    (H, Wa+Wb) in [0, 1]."""
    ha, wa = img_a.shape
    hb, wb = img_b.shape
    canvas = np.zeros((max(ha, hb), wa + wb), np.float32)
    canvas[:ha, :wa] = img_a
    canvas[:hb, wa:] = img_b
    for x, y, s in zip(xa, ya, sa):
        _draw_circle(canvas, x, y, max(s / 2, 2), 1.0)
    for x, y, s in zip(xb, yb, sb):
        _draw_circle(canvas, x + wa, y, max(s / 2, 2), 1.0)
    for i, j in np.asarray(pairs):
        _draw_line(canvas, xa[i], ya[i], xb[j] + wa, yb[j], 1.0)
    return canvas


def save_image(path, img: np.ndarray) -> None:
    """Save a float [0,1] grayscale image as binary PGM (or via PIL)."""
    path = pathlib.Path(path)
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    if path.suffix.lower() == ".pgm":
        header = f"P5\n{u8.shape[1]} {u8.shape[0]}\n255\n".encode()
        path.write_bytes(header + u8.tobytes())
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"write {path}: non-PGM output needs PIL") from e
    Image.fromarray(u8).save(path)
