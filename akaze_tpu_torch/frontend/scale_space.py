"""Nonlinear scale-space operations in plain PyTorch (counterpart of the JAX
package's `akaze_tpu/frontend/scale_space.py`).

These are the arithmetic the CUDA kernels of `kernels/fed.py` reproduce:
every separable filter replicates the plane border and sums its taps in the
golden order (vertical pass, then horizontal; taps left to right, zero taps
skipped), in float32.  They run on any device and are the plain twins the
kernels are held against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
from akaze_tpu_torch.core.fed import EvolutionSpec, allocate_evolutions
from akaze_tpu_torch.core.image import gaussian_kernel, scharr_kernels


def shift(img: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """result[..., i, ...] = img[..., clamp(i + d, 0, n - 1), ...] along `axis`."""
    if d == 0:
        return img
    n = img.shape[axis]
    idx = torch.clamp(torch.arange(n, device=img.device) + d, 0, n - 1)
    return img.index_select(axis, idx)


def filter_1d(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along `axis` (-1 = x, -2 = y) with edge replication."""
    half = len(kernel) // 2
    acc = None
    for t, w in enumerate(np.asarray(kernel, np.float32)):
        if w == 0.0:
            continue
        term = float(w) * shift(img, t - half, axis)
        acc = term if acc is None else acc + term
    return acc


def separable_filter(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """ky along rows (y) then kx along columns (x) — the golden order."""
    return filter_1d(filter_1d(img, ky, axis=-2), kx, axis=-1)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    k = gaussian_kernel(sigma)
    return separable_filter(img, k, k)


def scharr(img: torch.Tensor, x_order: int, y_order: int, sigma_size: int = 1) -> torch.Tensor:
    """Scaled Scharr derivative along x (1, 0) or y (0, 1)."""
    if (x_order, y_order) not in ((1, 0), (0, 1)):
        raise ValueError(f"scharr takes order (1, 0) or (0, 1), got {(x_order, y_order)}")
    deriv, smooth = scharr_kernels(sigma_size)
    if x_order == 1:
        return separable_filter(img, kx=deriv, ky=smooth)
    return separable_filter(img, kx=smooth, ky=deriv)


def half_size(img: torch.Tensor) -> torch.Tensor:
    """2x2 box mean; a trailing odd row or column is dropped."""
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    c = img[..., : 2 * h2, : 2 * w2]
    return 0.25 * (
        c[..., 0::2, 0::2] + c[..., 1::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 1::2]
    )


def contrast_factor_from_modg(modg: torch.Tensor, config: AkazeConfig) -> torch.Tensor:
    """Per-frame contrast factor k from |grad(G_1 * img)| planes (B, H, W).

    k is the gradient magnitude at the `contrast_percentile` of a histogram
    of the interior pixels (the 1-px frame excluded), found as the first bin
    whose cumulative f32 count reaches the threshold.  Counts come from one
    bincount over (frame, bin) pairs; they are integers below 2^24, so the
    f32 cumulative sums are exact in any order."""
    b = modg.shape[0]
    m = modg[..., 1:-1, 1:-1].reshape(b, -1)
    hmax = m.amax(dim=1)
    valid = m > 0.0
    npoints = valid.sum(dim=1)
    nbins = config.contrast_nbins
    safe = torch.where(hmax > 0, hmax, torch.ones_like(hmax))
    bins = torch.clamp(torch.floor(nbins * (m / safe[:, None])).to(torch.int32), max=nbins - 1)
    frame = torch.arange(b, device=m.device, dtype=torch.int64)[:, None].expand_as(bins)
    flat = (frame * nbins + bins.to(torch.int64))[valid]
    counts = torch.bincount(flat, minlength=b * nbins).reshape(b, nbins).to(torch.float32)
    csum = torch.cumsum(counts, dim=1)
    nthreshold = npoints.to(torch.float32) * config.contrast_percentile
    crossed = csum >= nthreshold[:, None]
    # `crossed` is monotone along the bins: its False count is the first
    # crossing's index.
    idx = (~crossed).sum(dim=1).to(torch.float32)
    k = safe * (idx + 1.0) / nbins
    bad = (hmax <= 0.0) | ~crossed.any(dim=1)
    return torch.where(bad, torch.full_like(k, config.contrast_fallback), k)


def conductivity(lx: torch.Tensor, ly: torch.Tensor, k: torch.Tensor, kind: Diffusivity) -> torch.Tensor:
    """g1 / g2 / Weickert diffusivities; k broadcasts against lx."""
    grad2 = (lx * lx + ly * ly) / (k * k)
    if kind == Diffusivity.PM_G2:
        return 1.0 / (1.0 + grad2)
    if kind == Diffusivity.PM_G1:
        return torch.exp(-grad2)
    if kind == Diffusivity.WEICKERT:
        g2_4 = grad2 * grad2
        g2_4 = g2_4 * g2_4
        safe = torch.where(g2_4 > 0, g2_4, torch.ones_like(g2_4))
        # A true division, as kernels 2 and 5 and the reference compute it:
        # `-3.315 / safe` would run as reciprocal(safe) * -3.315, which
        # rounds differently on ~25 % of pixels.
        return torch.where(grad2 > 0.0, 1.0 - torch.exp(torch.full_like(safe, -3.315) / safe),
                           torch.ones_like(g2_4))
    raise ValueError(kind)


def diffusion_step(lt: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit FED step of dL/dt = div(g grad L) with zero-flux borders:
    L += tau/2 * sum_n (g_c + g_n)(L_n - L_c), neighbours E, W, S, N."""
    step = (
        (g + shift(g, 1, -1)) * (shift(lt, 1, -1) - lt)
        + (g + shift(g, -1, -1)) * (shift(lt, -1, -1) - lt)
        + (g + shift(g, 1, -2)) * (shift(lt, 1, -2) - lt)
        + (g + shift(g, -1, -2)) * (shift(lt, -1, -2) - lt)
    )
    return lt + float(np.float32(0.5 * tau)) * step


def fed_cycle(lt: torch.Tensor, g: torch.Tensor, taus: Sequence[float]) -> torch.Tensor:
    for tau in taus:
        lt = diffusion_step(lt, g, tau)
    return lt


def detector_response_level(lsmooth: torch.Tensor, sigma_size: int):
    """sigma_size-scaled Scharr cascade: (Lx * s, Ly * s, Ldet) with
    Ldet = (Lxx s^2)(Lyy s^2) - (Lxy s^2)^2."""
    s = sigma_size
    lx = scharr(lsmooth, 1, 0, s)
    ly = scharr(lsmooth, 0, 1, s)
    lxx = scharr(lx, 1, 0, s)
    lyy = scharr(ly, 0, 1, s)
    lxy = scharr(lx, 0, 1, s)
    sf = float(s)
    s2 = float(s * s)
    ldet = (lxx * s2) * (lyy * s2) - (lxy * s2) * (lxy * s2)
    return lx * sf, ly * sf, ldet


@dataclasses.dataclass(frozen=True)
class LevelTables:
    """The per-level tables of a `ScaleSpaceStatics` on one device."""

    ratios: torch.Tensor  # (L,) float32
    sizes: torch.Tensor  # (L,) float32
    octaves: torch.Tensor  # (L,) int32
    widths: torch.Tensor  # (L,) int32
    heights: torch.Tensor  # (L,) int32
    scale: torch.Tensor  # (L,) int32, the descriptor's sampling step
    interior: torch.Tensor  # (L, H0, W0) bool
    nms: torch.Tensor  # (2, L) float32: ratios, squared dedup radii (the NMS kernel's table)
    level_f: torch.Tensor  # (L, 4) float32: ratio, scale, xmax, ymax
    level_i: torch.Tensor  # (L, 2) int64: octave group, plane in the group


class ScaleSpaceStatics:
    """Static per-level metadata shared by detection and description
    (numpy, computed as the JAX package computes it), and its device copies
    (`on`)."""

    def __init__(self, width: int, height: int, config: AkazeConfig):
        self.config = config
        self.specs: List[EvolutionSpec] = allocate_evolutions(width, height, config)
        self.num_levels = L = len(self.specs)
        self.h0, self.w0 = self.specs[0].height, self.specs[0].width
        self.widths = np.array([s.width for s in self.specs], np.int32)
        self.heights = np.array([s.height for s in self.specs], np.int32)
        self.octaves = np.array([s.octave for s in self.specs], np.int32)
        self.ratios = np.array([s.ratio for s in self.specs], np.float32)
        self.esigmas = np.array([s.esigma for s in self.specs], np.float32)
        self.sigma_sizes = np.array([s.sigma_size for s in self.specs], np.int32)
        self.borders = np.array([s.border for s in self.specs], np.int32)
        self.sizes = (self.esigmas * config.derivative_factor).astype(np.float32)
        # Reference `scale = max(1, round(0.5 * size / ratio))` per level: the
        # descriptor's sampling step in level pixels.
        self.scale = np.maximum(np.floor(0.5 * self.sizes / self.ratios + 0.5).astype(np.int32), 1)
        # (L, H0, W0) mask of the padded stacks: inside each level's border.
        ys = np.arange(self.h0)[None, :, None]
        xs = np.arange(self.w0)[None, None, :]
        b = self.borders[:, None, None]
        self.interior = ((ys >= b) & (ys < self.heights[:, None, None] - b)
                         & (xs >= b) & (xs < self.widths[:, None, None] - b))
        # Per octave (first level, level count, h, w) of the level list.
        groups, lvl = [], 0
        while lvl < L:
            h, w = int(self.heights[lvl]), int(self.widths[lvl])
            n = 1
            while lvl + n < L and int(self.heights[lvl + n]) == h:
                n += 1
            groups.append((lvl, n, h, w))
            lvl += n
        self.groups = tuple(groups)
        # Per level (4, L) float32 ratio, scale, xmax = width - 1, ymax =
        # height - 1, and (2, L) int32 octave group and plane in the group:
        # the level tables of the describe kernel and its twin.
        self.level_f = np.stack([self.ratios, self.scale, self.widths - 1, self.heights - 1]).astype(np.float32)
        self.level_i = np.zeros((2, L), np.int32)
        for g, (l0, n, _, _) in enumerate(self.groups):
            self.level_i[0, l0 : l0 + n] = g
            self.level_i[1, l0 : l0 + n] = np.arange(n)
        self._on = {}

    def on(self, device) -> LevelTables:
        """The per-level tables on `device`: copied there on the first call
        for that device, then kept as long as the statics."""
        device = torch.device(device)
        tables = self._on.get(device)
        if tables is None:
            up = lambda a: torch.as_tensor(a, device=device)
            r2 = (self.config.dedup_radius_factor * self.sizes) ** 2
            tables = self._on[device] = LevelTables(
                ratios=up(self.ratios), sizes=up(self.sizes), octaves=up(self.octaves), widths=up(self.widths),
                heights=up(self.heights), scale=up(self.scale), interior=up(self.interior),
                nms=up(np.stack([self.ratios, r2]).astype(np.float32)), level_f=up(self.level_f.T.copy()),
                level_i=up(self.level_i.T.astype(np.int64)))
        return tables


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    """floor(x + 0.5) as int32: the reference's sample-coordinate rounding."""
    return torch.floor(x + 0.5).to(torch.int32)
