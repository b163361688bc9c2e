"""Deterministic synthetic scenes (own copy of the JAX package's
`textured_scene`, `video_sequence`, `warp_homography`, `multi_plane_pair`,
`sfm_scene` and the five adversarial scene classes of `SCENE_CLASSES`,
numpy only).  Same seed, same pixels as the reference, so the two packages
can be fed identical frames.  Pass shapes and seeds as Python ints: an
np.int64 scalar promotes the float32 arithmetic to float64 and changes the
pixels at the ulp level."""

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


def rotation_homography(height: int, width: int, angle_rad: float) -> np.ndarray:
    """Homography rotating the image about its center by `angle_rad`."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    t0 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    t1 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    return t1 @ r @ t0


def rotated_scene(height: int = 480, width: int = 640, angle_rad: float = 0.6, seed: int = 0) -> np.ndarray:
    """Rotation-dominant warp of the textured scene (adversarial for the
    cross-level NMS chains and the orientation assignment)."""
    base = textured_scene(height, width, seed=seed)
    return warp_homography(base, rotation_homography(height, width, angle_rad))


def low_texture_scene(height: int = 480, width: int = 640, seed: int = 0) -> np.ndarray:
    """Weak-gradient scene: smooth ramps and a few faint wide blobs.  It
    stresses the contrast-factor percentile and the detector threshold
    (few, weak extrema, where count parity is fragile)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    img = 0.5 + 0.05 * np.sin(2 * np.pi * x / width) + 0.04 * (y / height)
    for _ in range(12):
        cx = rng.uniform(0.1, 0.9) * width
        cy = rng.uniform(0.1, 0.9) * height
        s = rng.uniform(5.0, 18.0)
        img += rng.uniform(-0.12, 0.12) * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * s * s))
    img += 0.004 * rng.normal(0.0, 1.0, img.shape).astype(np.float32)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img.astype(np.float32)


def repetitive_grid_scene(height: int = 480, width: int = 640, seed: int = 0) -> np.ndarray:
    """Strictly periodic grid of blobs: every extremum has near-identical
    twins one period away, the worst case for the NMS radius and chain
    rules and for the matcher's ratio test."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    p = 24.0
    img = 0.4 + 0.25 * np.cos(2 * np.pi * x / p) * np.cos(2 * np.pi * y / p)
    img += 0.1 * ((np.floor(x / p) + np.floor(y / p)) % 2 - 0.5)
    img += 0.01 * rng.normal(0.0, 1.0, img.shape).astype(np.float32)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def illumination_ramp_scene(height: int = 480, width: int = 640, seed: int = 0) -> np.ndarray:
    """The textured scene under a strong multiplicative illumination ramp
    and a vignette: stresses the contrast factor and the descriptor's
    mean comparisons."""
    base = textured_scene(height, width, seed=seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    ramp = 0.35 + 0.65 * (x / width)
    cx, cy = width / 2.0, height / 2.0
    r2 = ((x - cx) / width) ** 2 + ((y - cy) / height) ** 2
    vignette = 1.0 - 0.5 * r2 / r2.max()
    img = base * ramp * vignette + 0.05
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


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


#: The adversarial scene classes, each called as f(height, width, seed=seed).
SCENE_CLASSES = {
    "textured": textured_scene,
    "rotated": rotated_scene,
    "low_texture": low_texture_scene,
    "repetitive_grid": repetitive_grid_scene,
    "illumination_ramp": illumination_ramp_scene,
}


def _rotvec_to_matrix_np(rv: np.ndarray) -> np.ndarray:
    """Rodrigues in plain numpy (keeps this module JAX-free)."""
    th = float(np.linalg.norm(rv))
    if th < 1e-12:
        return np.eye(3)
    ax = rv / th
    kx = np.array(
        [[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]]
    )
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * (kx @ kx)


def sfm_scene(
    num_keyframes: int,
    num_points: int,
    seed: int = 0,
    loop: bool = False,
    obs_noise: float = 5e-4,
    num_closures: int = 3,
    closure_rot_noise: float = 0.002,
    closure_t_noise: float = 0.01,
):
    """Synthetic SfM benchmark scene (BASELINE.json config 5).

    Returns (poses_gt (K, 6) camera-from-world [rotvec|t], observations
    [{keyframe: normalized uv}], closures [(i, j, rel6)]).

    loop=False is the open trajectory of the JAX package's bench scene
    (same rng draw order): a gently yawing forward trajectory, points in a fixed box
    (K <= 50) or anchored along the path (K > 50); closures is empty.

    loop=True: the trajectory closes a
    full circle — the camera drives a planar loop looking along the
    tangent, so late keyframes genuinely REVISIT the first keyframes'
    viewpoint and re-observe their anchored points (long re-observation
    tracks), and `num_closures` verified loop-closure edges (i near 0,
    j near K) are derived from the ground-truth relative pose plus noise
    at the measured two-view accuracy (BASELINE.md: rot ~0.2-0.4 deg) —
    simulating what sfm/loop_closure.detect_loop_closures measures from
    descriptor matches when real imagery is available.  Path length
    matches the non-loop scene (~0.15 units/keyframe) so drift rates are
    comparable.
    """
    rng = np.random.default_rng(seed)
    K = num_keyframes
    poses = np.zeros((K, 6), np.float32)
    if not loop:
        for k in range(K):
            poses[k, :3] = [0.0, (0.02 if K <= 50 else 0.003) * k, 0.0]
            poses[k, 3:] = [-0.15 * k, 0.005 * np.sin(0.1 * k), 0.02]
    else:
        radius = 0.15 * K / (2 * np.pi)  # same per-step baseline as non-loop
        for k in range(K):
            phi = 2 * np.pi * k / K
            alpha = phi - np.pi / 2  # camera forward = path tangent
            center = radius * np.array([np.sin(phi), 0.0, -np.cos(phi)])
            center[1] = 0.005 * np.sin(0.1 * k)  # mild vertical wobble
            r_cw = _rotvec_to_matrix_np(np.array([0.0, alpha, 0.0]))
            poses[k, :3] = [0.0, alpha, 0.0]
            poses[k, 3:] = -r_cw @ center
    rots = [_rotvec_to_matrix_np(poses[k, :3]) for k in range(K)]

    if K <= 50 and not loop:
        pts = rng.uniform([-4, -3, 8], [4, 3, 20], (num_points, 3))
    else:
        # Distribute points along the path (a fixed box leaves late cameras
        # with nothing to see): anchor each point in front of a keyframe.
        anchors = rng.integers(0, K, num_points)
        local = np.stack([
            rng.uniform(-2, 2, num_points),
            rng.uniform(-1.5, 1.5, num_points),
            rng.uniform(6, 14, num_points),
        ], axis=1)
        pts = np.stack([
            rots[a].T @ (local[p] - poses[a, 3:])
            for p, a in enumerate(anchors)
        ])

    observations = []
    # Loop scenes use a narrower FOV gate: at +-0.6 the slow turn rate
    # (1.8 deg/kf at K=200) keeps points visible for ~60 keyframes and the
    # resulting long tracks chain BA so strongly that open-loop drift is
    # ~1e-3 of the trajectory — nothing left for loop closures to bound.
    # +-0.35 (~19 deg half-FOV) gives realistic track lengths and real
    # accumulated drift for the closure machinery to correct.
    view_gate = 0.35 if loop else 0.6
    for p in range(len(pts)):
        tr = {}
        for k in range(K):
            xc = rots[k] @ pts[p] + poses[k, 3:]
            if xc[2] > 0.1:
                uv = xc[:2] / xc[2]
                if np.abs(uv).max() < view_gate:
                    tr[k] = (uv + rng.normal(0, obs_noise, 2)).astype(np.float32)
        if loop:
            # A real front-end without place recognition does NOT
            # re-associate a landmark that left the field of view for many
            # frames — on the revisit it creates a NEW track for the same
            # physical point.  Split tracks at visibility gaps > 3 frames
            # accordingly; the closure edges then carry ALL the
            # loop-constraint information (that is the configuration the
            # drift-bounding machinery exists for — an unsplit track list
            # lets BA's long re-observation tracks bound drift by itself,
            # measured ATE 0.005 at 200 kf, and closures only add noise).
            frames = sorted(tr)
            seg: dict = {}
            for f in frames:
                if seg and f - max(seg) > 3:
                    if len(seg) >= 2:
                        observations.append(seg)
                    seg = {}
                seg[f] = tr[f]
            if len(seg) >= 2:
                observations.append(seg)
        elif len(tr) >= 2:
            observations.append(tr)

    closures = []
    if loop:
        # Loop-closure edges pairing the revisit tail with the start; all
        # later keyframes j sit inside the FINAL ba_every window for any
        # ba_every >= num_closures + 1, so pose-graph optimization + BA
        # re-polish trigger once, at the end of the loop.
        for c in range(num_closures):
            i, j = c, K - num_closures - 1 + c
            ri, rj = rots[i], rots[j]
            r_rel = rj @ ri.T  # cam_j-from-cam_i
            t_rel = poses[j, 3:] - r_rel @ poses[i, 3:]
            rel6 = np.zeros(6, np.float32)
            # matrix -> rotvec (angle well below pi for these pairs)
            cth = np.clip((np.trace(r_rel) - 1) / 2, -1.0, 1.0)
            th = np.arccos(cth)
            if th > 1e-9:
                ax = np.array([
                    r_rel[2, 1] - r_rel[1, 2],
                    r_rel[0, 2] - r_rel[2, 0],
                    r_rel[1, 0] - r_rel[0, 1],
                ]) / (2 * np.sin(th))
                rel6[:3] = th * ax
            rel6[:3] += rng.normal(0, closure_rot_noise, 3)
            # UNIT-normalized translation: monocular closures carry
            # direction + rotation only (sfm.incremental._apply_pose_graph
            # rescales to the current estimate's baseline norm — a metric
            # translation here would get scaled TWICE).
            t_noisy = t_rel + rng.normal(0, closure_t_noise * max(
                np.linalg.norm(t_rel), 1e-6), 3)
            rel6[3:] = t_noisy / max(np.linalg.norm(t_noisy), 1e-9)
            closures.append((i, j, rel6))
    return poses, observations, closures
