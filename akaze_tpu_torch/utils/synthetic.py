"""Deterministic synthetic scenes (own copy of the JAX package's
`textured_scene`, `video_sequence`, `warp_homography` and
`multi_plane_pair`, numpy only).  Same seed, same pixels as the reference,
so the two packages can be fed identical frames."""

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


def warp_homography(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse-warp `img` by homography H (maps src -> dst), bilinear sampling."""
    height, width = img.shape
    yd, xd = np.mgrid[0:height, 0:width].astype(np.float64)
    Hinv = np.linalg.inv(H)
    w = Hinv[2, 0] * xd + Hinv[2, 1] * yd + Hinv[2, 2]
    xs = (Hinv[0, 0] * xd + Hinv[0, 1] * yd + Hinv[0, 2]) / w
    ys = (Hinv[1, 0] * xd + Hinv[1, 1] * yd + Hinv[1, 2]) / w
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, width - 2)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, height - 2)
    fx = np.clip(xs - x0, 0.0, 1.0)
    fy = np.clip(ys - y0, 0.0, 1.0)
    out = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    inside = (xs >= 0) & (xs <= width - 1) & (ys >= 0) & (ys <= height - 1)
    return np.where(inside, out, 0.0).astype(np.float32)


def multi_plane_pair(height: int = 240, width: int = 320, seed: int = 5, rows: int = 2, cols: int = 3):
    """Calibrated two-view pair with known relative pose: the second view
    sees a rows x cols grid of planes (distinct normals and depths) of the
    textured scene under a known (R, t).  One plane would be degenerate for
    the essential matrix; six give a well-posed E.  Returns (img_a, img_b,
    R, t, intrinsics) with |t| = 1 and intrinsics (fx, fy, cx, cy)."""
    rng = np.random.default_rng(seed + 1000)
    img_a = textured_scene(height, width, seed=seed)
    rvec = np.array([0.02, -0.03, 0.01])
    th = np.linalg.norm(rvec)
    ax = rvec / th
    kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)
    t = np.array([0.6, 0.1, 0.15])
    t /= np.linalg.norm(t)
    K = np.array([[width, 0, width / 2], [0, width, height / 2], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    img_b = np.zeros_like(img_a)
    yy, xx = np.mgrid[0:height, 0:width]
    for r in range(rows):
        for c in range(cols):
            n = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35), 1.0])
            n /= np.linalg.norm(n)
            d = rng.uniform(4.0, 10.0)
            Hp = K @ (R - np.outer(t, n) / d) @ Kinv  # pixel homography a -> b
            warp = warp_homography(img_a, Hp)
            region = (yy * rows // height == r) & (xx * cols // width == c)
            img_b = np.where(region, warp, img_b)
    return img_a, img_b.astype(np.float32), R, t, (float(width), float(width), width / 2.0, height / 2.0)
