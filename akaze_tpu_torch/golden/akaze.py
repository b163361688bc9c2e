"""Golden (parity-oracle) NumPy implementation of the full AKAZE pipeline
(own copy of the JAX package's `golden/akaze.py`; only the imports differ).

It stays NumPy, not torch, on purpose: its worth is that it is independent
of the port's torch code, so it can stand beside the card as an oracle on a
machine without JAX, and the checked-in snapshots
(`tests/data/golden_snapshot.npz`, `golden_scene_snapshots.npz`) pin its
output exactly.  It follows the reference's *sequential* extrema
semantics.

Pipeline:
    scale space (FED nonlinear diffusion) -> det-Hessian responses ->
    scale-space extrema + sub-pixel -> orientation -> M-LDB 486-bit descriptor.

Intentionally simple, loop-heavy NumPy: clarity and fidelity over speed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
from akaze_tpu_torch.core.fed import EvolutionSpec, allocate_evolutions
from akaze_tpu_torch.core.image import (
    gaussian_blur,
    half_size,
    round_half_up,
    scharr,
)


@dataclasses.dataclass
class Evolution:
    """One scale-space level: static spec + image buffers (SURVEY.md §2 C3)."""

    spec: EvolutionSpec
    Lt: np.ndarray | None = None  # diffused image (post-FED)
    Lsmooth: np.ndarray | None = None  # sigma=1.0 Gaussian of the level's seed Lt
    Lx: np.ndarray | None = None  # sigma_size-normalized detector derivatives
    Ly: np.ndarray | None = None
    Ldet: np.ndarray | None = None  # scale-normalized det-Hessian response


@dataclasses.dataclass
class Keypoint:
    """Reference keypoint (SURVEY.md §2 C2); (x, y) in octave-0 image coords."""

    x: float
    y: float
    response: float
    size: float
    octave: int
    class_id: int  # evolution level index
    angle: float = 0.0


# --------------------------------------------------------------------------
# Scale space (SURVEY.md §3.2 — hot loop A)
# --------------------------------------------------------------------------


def compute_contrast_factor(img: np.ndarray, config: AkazeConfig) -> float:
    """k = gradient magnitude at config.contrast_percentile of a histogram of
    |grad(G_{sigma=1} * img)| over interior pixels (SURVEY.md §2 C6)."""
    smoothed = gaussian_blur(img, 1.0)
    lx = scharr(smoothed, 1, 0, 1)
    ly = scharr(smoothed, 0, 1, 1)
    modg = np.sqrt(lx * lx + ly * ly)[1:-1, 1:-1]
    hmax = float(modg.max())
    if hmax == 0.0:
        return config.contrast_fallback
    valid = modg > 0.0
    npoints = int(valid.sum())
    nbins = config.contrast_nbins
    bins = np.floor(nbins * (modg[valid] / hmax)).astype(np.int64)
    bins = np.minimum(bins, nbins - 1)
    hist = np.bincount(bins, minlength=nbins)
    nthreshold = npoints * config.contrast_percentile
    csum = np.cumsum(hist)
    idx = np.argwhere(csum >= nthreshold)
    if idx.size == 0:
        return config.contrast_fallback
    # Reference loop exits with k = index-after-the-crossing-bin.
    return hmax * float(idx[0, 0] + 1) / nbins


def conductivity_np(lx: np.ndarray, ly: np.ndarray, k: float, kind: Diffusivity) -> np.ndarray:
    """g1 / g2 / Weickert diffusivities (SURVEY.md §2 C5)."""
    grad2 = (lx * lx + ly * ly) / np.float32(k * k)
    if kind == Diffusivity.PM_G2:
        return (1.0 / (1.0 + grad2)).astype(np.float32)
    if kind == Diffusivity.PM_G1:
        return np.exp(-grad2).astype(np.float32)
    if kind == Diffusivity.WEICKERT:
        # (|grad|/k)^8 = grad2^4
        g2_4 = grad2 * grad2
        g2_4 = g2_4 * g2_4
        with np.errstate(divide="ignore"):
            g = 1.0 - np.exp(-3.315 / g2_4)
        return np.where(grad2 > 0.0, g, 1.0).astype(np.float32)
    raise AssertionError(kind)


def diffusion_step(lt: np.ndarray, g: np.ndarray, tau: float) -> np.ndarray:
    """One explicit step of dL/dt = div(g * grad L) with zero-flux borders:
    L += 0.5*tau * sum_neighbors (g_c + g_n)(L_n - L_c)  (SURVEY.md §2 C5)."""
    lp = np.pad(lt, 1, mode="edge")
    gp = np.pad(g, 1, mode="edge")
    c, cg = lp[1:-1, 1:-1], gp[1:-1, 1:-1]
    step = np.zeros_like(lt, dtype=np.float32)
    for ln, gn in (
        (lp[1:-1, 2:], gp[1:-1, 2:]),  # x+1
        (lp[1:-1, :-2], gp[1:-1, :-2]),  # x-1
        (lp[2:, 1:-1], gp[2:, 1:-1]),  # y+1
        (lp[:-2, 1:-1], gp[:-2, 1:-1]),  # y-1
    ):
        step += (cg + gn) * (ln - c)
    return (lt + np.float32(0.5 * tau) * step).astype(np.float32)


def create_nonlinear_scale_space(img: np.ndarray, config: AkazeConfig) -> List[Evolution]:
    """SURVEY.md §3.1/§3.2: per level, seed Lt from the previous level (half-
    sized at octave changes, contrast k *= 0.75), Lsmooth = G_{1.0}(seed Lt),
    conductivity from grad(Lsmooth), then the level's FED tau sweeps."""
    specs = allocate_evolutions(img.shape[1], img.shape[0], config)
    evolutions = [Evolution(spec=s) for s in specs]

    lt = gaussian_blur(img.astype(np.float32), config.base_scale_offset)
    evolutions[0].Lt = lt
    evolutions[0].Lsmooth = lt.copy()

    k = compute_contrast_factor(img, config)
    for i in range(1, len(evolutions)):
        ev, prev = evolutions[i], evolutions[i - 1]
        if ev.spec.octave > prev.spec.octave:
            lt = half_size(prev.Lt)
            k *= config.contrast_octave_decay
        else:
            lt = prev.Lt.copy()
        ev.Lsmooth = gaussian_blur(lt, 1.0)
        lx = scharr(ev.Lsmooth, 1, 0, 1)
        ly = scharr(ev.Lsmooth, 0, 1, 1)
        g = conductivity_np(lx, ly, k, config.diffusivity)
        for tau in ev.spec.taus:
            lt = diffusion_step(lt, g, tau)
        ev.Lt = lt
    return evolutions


# --------------------------------------------------------------------------
# Detector response (SURVEY.md §2 C8 — hot loop B)
# --------------------------------------------------------------------------


def detector_response(evolutions: List[Evolution], config: AkazeConfig) -> None:
    """Per level: sigma_size-scaled Scharr derivatives of Lsmooth, normalized
    by sigma_size^order; Ldet = Lxx*Lyy - Lxy^2 (scale-normalized det-Hessian)."""
    for ev in evolutions:
        s = ev.spec.sigma_size
        lx = scharr(ev.Lsmooth, 1, 0, s)
        ly = scharr(ev.Lsmooth, 0, 1, s)
        lxx = scharr(lx, 1, 0, s)
        lyy = scharr(ly, 0, 1, s)
        lxy = scharr(lx, 0, 1, s)
        ev.Lx = lx * np.float32(s)
        ev.Ly = ly * np.float32(s)
        s2 = np.float32(s * s)
        ev.Ldet = (lxx * s2) * (lyy * s2) - (lxy * s2) * (lxy * s2)


# --------------------------------------------------------------------------
# Extrema + sub-pixel refinement (SURVEY.md §2 C9 — sequential reference
# semantics; the TPU path re-formulates this as parallel NMS and is parity-
# tested against THIS implementation)
# --------------------------------------------------------------------------


def find_scale_space_extrema(evolutions: List[Evolution], config: AkazeConfig) -> List[Keypoint]:
    aux: List[Keypoint] = []
    for ev in evolutions:
        spec = ev.spec
        ld = ev.Ldet
        h, w = ld.shape
        border = spec.border
        if h - 2 * border <= 0 or w - 2 * border <= 0:
            continue
        interior = ld[border:-border, border:-border]
        neighbor_max = _neighbor_max_3x3(ld)[border:-border, border:-border]
        cand = (interior > config.detector_threshold) & (interior > neighbor_max)
        ys, xs = np.nonzero(cand)
        size = spec.esigma * config.derivative_factor
        radius2 = (config.dedup_radius_factor * size) ** 2
        ratio = float(spec.ratio)
        # Raster order within the level, levels in order: reference semantics.
        for y0, x0 in zip(ys + border, xs + border):
            point = Keypoint(
                x=float(x0) * ratio,
                y=float(y0) * ratio,
                response=float(ld[y0, x0]),
                size=size,
                octave=spec.octave,
                class_id=spec.index,
            )
            is_extremum = True
            repeated_idx = -1
            for idx, other in enumerate(aux):
                if other.class_id in (spec.index, spec.index - 1):
                    dx = point.x - other.x
                    dy = point.y - other.y
                    if dx * dx + dy * dy <= radius2:
                        if point.response > other.response:
                            repeated_idx = idx
                        else:
                            is_extremum = False
                        break
            if is_extremum:
                if repeated_idx >= 0:
                    aux[repeated_idx] = point
                else:
                    aux.append(point)

    # Second pass: drop a point if a *later-level* (class_id + 1) point within
    # radius has strictly greater response (SURVEY.md §2 C9 "survives at i+1").
    kept: List[Keypoint] = []
    for i, point in enumerate(aux):
        radius2 = (config.dedup_radius_factor * point.size) ** 2
        repeated = False
        for other in aux[i + 1 :]:
            if other.class_id == point.class_id + 1:
                dx = point.x - other.x
                dy = point.y - other.y
                if dx * dx + dy * dy <= radius2 and point.response < other.response:
                    repeated = True
                    break
        if not repeated:
            kept.append(point)
    return [kp for kp in (do_subpixel_refinement(k, evolutions) for k in kept) if kp is not None]


def _neighbor_max_3x3(ld: np.ndarray) -> np.ndarray:
    """Max over the 8 neighbors (center excluded), -inf beyond the border."""
    p = np.pad(ld, 1, mode="constant", constant_values=-np.inf)
    shifts = [
        p[0:-2, 0:-2], p[0:-2, 1:-1], p[0:-2, 2:],
        p[1:-1, 0:-2], p[1:-1, 2:],
        p[2:, 0:-2], p[2:, 1:-1], p[2:, 2:],
    ]
    return np.maximum.reduce(shifts)


def do_subpixel_refinement(kp: Keypoint, evolutions: List[Evolution]) -> Keypoint | None:
    """2-variable quadratic fit on Ldet; reject if |offset| > 1 (SURVEY.md C9)."""
    ev = evolutions[kp.class_id]
    ld = ev.Ldet
    ratio = float(ev.spec.ratio)
    x = int(round_half_up(kp.x / ratio))
    y = int(round_half_up(kp.y / ratio))
    dx = 0.5 * (ld[y, x + 1] - ld[y, x - 1])
    dy = 0.5 * (ld[y + 1, x] - ld[y - 1, x])
    dxx = ld[y, x + 1] + ld[y, x - 1] - 2.0 * ld[y, x]
    dyy = ld[y + 1, x] + ld[y - 1, x] - 2.0 * ld[y, x]
    dxy = 0.25 * (ld[y + 1, x + 1] + ld[y - 1, x - 1] - ld[y - 1, x + 1] - ld[y + 1, x - 1])
    det = dxx * dyy - dxy * dxy
    if abs(det) < 1e-30:
        return None
    ox = (-dx * dyy + dy * dxy) / det
    oy = (-dy * dxx + dx * dxy) / det
    if abs(ox) > 1.0 or abs(oy) > 1.0:
        return None
    return dataclasses.replace(kp, x=(x + ox) * ratio, y=(y + oy) * ratio)


# --------------------------------------------------------------------------
# Orientation (SURVEY.md §2 C10 — SURF-style dominant orientation)
# --------------------------------------------------------------------------

_ORI_OFFSETS = [(i, j) for i in range(-6, 7) for j in range(-6, 7) if i * i + j * j < 36]


def compute_main_orientation(kp: Keypoint, evolutions: List[Evolution]) -> float:
    ev = evolutions[kp.class_id]
    ratio = float(ev.spec.ratio)
    s = max(1, int(round_half_up(0.5 * kp.size / ratio)))
    xf, yf = kp.x / ratio, kp.y / ratio
    h, w = ev.Lx.shape

    res_x, res_y, ang = [], [], []
    for i, j in _ORI_OFFSETS:  # i -> x offset, j -> y offset (grid units of s)
        ix = int(np.clip(round_half_up(xf + i * s), 0, w - 1))
        iy = int(np.clip(round_half_up(yf + j * s), 0, h - 1))
        gweight = math.exp(-(i * i + j * j) / (2.0 * 2.5 * 2.5))
        rx = gweight * ev.Lx[iy, ix]
        ry = gweight * ev.Ly[iy, ix]
        res_x.append(rx)
        res_y.append(ry)
        ang.append(math.atan2(ry, rx) % (2.0 * math.pi))

    best_norm, best_angle = -1.0, 0.0
    ang1 = 0.0
    while ang1 < 2.0 * math.pi:
        ang2 = ang1 + math.pi / 3.0
        wrap = ang2 > 2.0 * math.pi
        if wrap:
            ang2 -= 2.0 * math.pi
        sum_x = sum_y = 0.0
        for rx, ry, a in zip(res_x, res_y, ang):
            inside = (ang1 < a < ang2) if not wrap else (a > ang1 or a < ang2)
            if inside:
                sum_x += rx
                sum_y += ry
        norm = sum_x * sum_x + sum_y * sum_y
        if norm > best_norm:
            best_norm = norm
            best_angle = math.atan2(sum_y, sum_x) % (2.0 * math.pi)
        ang1 += 0.15
    return best_angle


# --------------------------------------------------------------------------
# M-LDB descriptor (SURVEY.md §2 C11): grids 2x2/3x3/4x4 over a rotated
# 2p x 2p patch, per-cell means of (Lt, rotated Lx, rotated Ly), pairwise
# comparisons channel-major -> 486 bits -> 61 bytes (LSB-first within bytes).
# --------------------------------------------------------------------------


def _mldb_fill_values(
    kp: Keypoint,
    ev: Evolution,
    sample_step: int,
    co: float,
    si: float,
    scale: int,
    pattern_size: int,
) -> np.ndarray:
    """Per-cell channel means; cells iterate i (x-ish) outer, j inner."""
    ratio = float(ev.spec.ratio)
    xf, yf = kp.x / ratio, kp.y / ratio
    h, w = ev.Lt.shape
    values = []
    for i in range(-pattern_size, pattern_size, sample_step):
        for j in range(-pattern_size, pattern_size, sample_step):
            di = dx = dy = 0.0
            nsamples = 0
            for k in range(i, i + sample_step):
                for l in range(j, j + sample_step):
                    sample_y = yf + (l * co + k * si) * scale
                    sample_x = xf + (-l * si + k * co) * scale
                    y1 = int(np.clip(round_half_up(sample_y), 0, h - 1))
                    x1 = int(np.clip(round_half_up(sample_x), 0, w - 1))
                    ri = ev.Lt[y1, x1]
                    rx = ev.Lx[y1, x1]
                    ry = ev.Ly[y1, x1]
                    di += ri
                    # Gradient channels rotated into the keypoint frame.
                    dx += rx * co + ry * si
                    dy += -rx * si + ry * co
                    nsamples += 1
            values.append((di / nsamples, dx / nsamples, dy / nsamples))
    return np.asarray(values, dtype=np.float64)  # (cells, 3)


def get_mldb_descriptor(kp: Keypoint, evolutions: List[Evolution], config: AkazeConfig) -> np.ndarray:
    """486-bit M-LDB as uint8[61], bit b at byte b>>3, position b&7."""
    ev = evolutions[kp.class_id]
    ratio = float(ev.spec.ratio)
    scale = max(1, int(round_half_up(0.5 * kp.size / ratio)))
    co, si = math.cos(kp.angle), math.sin(kp.angle)
    p = config.descriptor_pattern_size

    desc = np.zeros(config.descriptor_bytes, dtype=np.uint8)
    dpos = 0
    for sample_step in (p, int(math.ceil(2.0 * p / 3.0)), p // 2):
        values = _mldb_fill_values(kp, ev, sample_step, co, si, scale, p)
        count = values.shape[0]
        for ch in range(config.descriptor_channels):
            for a in range(count):
                for b in range(a + 1, count):
                    if values[a, ch] > values[b, ch]:
                        desc[dpos >> 3] |= np.uint8(1 << (dpos & 7))
                    dpos += 1
    assert dpos == config.descriptor_bits
    return desc


def pack_descriptor_u32(desc_bytes: np.ndarray, num_words: int = 16) -> np.ndarray:
    """uint8[61] -> little-endian uint32[16] (512 bits, top 26 zero)."""
    padded = np.zeros(num_words * 4, dtype=np.uint8)
    padded[: desc_bytes.shape[0]] = desc_bytes
    return padded.view("<u4").copy()


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GoldenResult:
    keypoints: List[Keypoint]
    descriptors: np.ndarray  # uint8 (N, 61)
    descriptors_u32: np.ndarray  # uint32 (N, 16)
    evolutions: List[Evolution]


def extract(img: np.ndarray, config: AkazeConfig | None = None) -> GoldenResult:
    """Reference entry point `Akaze::extract` (SURVEY.md §3.1)."""
    config = config or AkazeConfig()
    img = np.asarray(img, dtype=np.float32)
    assert img.ndim == 2, "golden model expects a grayscale (H, W) image"
    evolutions = create_nonlinear_scale_space(img, config)
    detector_response(evolutions, config)
    keypoints = find_scale_space_extrema(evolutions, config)
    for kp in keypoints:
        kp.angle = compute_main_orientation(kp, evolutions)
    descs = (
        np.stack([get_mldb_descriptor(kp, evolutions, config) for kp in keypoints])
        if keypoints
        else np.zeros((0, config.descriptor_bytes), dtype=np.uint8)
    )
    descs_u32 = (
        np.stack([pack_descriptor_u32(d, config.descriptor_words) for d in descs])
        if len(descs)
        else np.zeros((0, config.descriptor_words), dtype=np.uint32)
    )
    return GoldenResult(keypoints, descs, descs_u32, evolutions)
