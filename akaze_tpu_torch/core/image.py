"""NumPy image primitives (own copy of the JAX package's golden
`image.py`): the rounding rule, the normalised Gaussian and the scaled
Scharr kernels, and the edge-replicating separable filters built on them.
Every port filter takes its taps from here, so the constants are the same
float32 values the reference uses; the filters serve the golden NumPy
model (`akaze_tpu_torch.golden`).  Images are float32 (H, W) arrays."""

from __future__ import annotations

import math

import numpy as np


def round_half_up(x):
    """floor(x + 0.5): the reference's coordinate rounding rule."""
    return np.floor(np.asarray(x) + 0.5).astype(np.int64)


def gaussian_kernel(sigma: float, half_width: int | None = None) -> np.ndarray:
    """Normalised 1-D Gaussian; auto size ksize = ceil(2*(1 + (sigma-0.8)/0.3))
    rounded up to odd (at least 3)."""
    if half_width is None:
        ksize = int(math.ceil(2.0 * (1.0 + (sigma - 0.8) / 0.3)))
        if ksize % 2 == 0:
            ksize += 1
        ksize = max(ksize, 3)
        half_width = ksize // 2
    x = np.arange(-half_width, half_width + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _filter_1d(img: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """Correlate along `axis` with replicate (edge) padding."""
    half = len(kernel) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (half, half)
    padded = np.pad(img, pad, mode="edge").astype(np.float32)
    out = np.zeros_like(img, dtype=np.float32)
    n = img.shape[axis]
    for tap, w in enumerate(kernel):
        if w == 0.0:
            continue
        sl = [slice(None), slice(None)]
        sl[axis] = slice(tap, tap + n)
        out += np.float32(w) * padded[tuple(sl)]
    return out


def separable_filter(img: np.ndarray, kx: np.ndarray, ky: np.ndarray) -> np.ndarray:
    """Apply ky along rows (axis 0 / y) then kx along columns (axis 1 / x)."""
    return _filter_1d(_filter_1d(img, ky, axis=0), kx, axis=1)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    k = gaussian_kernel(sigma)
    return separable_filter(img, k, k)


def half_size(img: np.ndarray) -> np.ndarray:
    """2x2 box-mean downsample to (H//2, W//2); trailing odd row/col dropped."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    c = img[: 2 * h2, : 2 * w2]
    return 0.25 * (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2])


def scharr_kernels(sigma_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Scaled-Scharr (derivative, smoothing) 1-D kernels of half-width
    `sigma_size`: derivative [-1, 0...0, +1], smoothing
    [norm, 0...0, w*norm, 0...0, norm] with w = 10/3 and
    norm = 1/(2*sigma_size*(w+2))."""
    ksize = 3 + 2 * (sigma_size - 1)
    w = 10.0 / 3.0
    norm = 1.0 / (2.0 * sigma_size * (w + 2.0))
    deriv = np.zeros(ksize, dtype=np.float32)
    deriv[0], deriv[-1] = -1.0, 1.0
    smooth = np.zeros(ksize, dtype=np.float32)
    smooth[0] = smooth[-1] = norm
    smooth[ksize // 2] = w * norm
    return deriv, smooth


def scharr(img: np.ndarray, x_order: int, y_order: int, sigma_size: int = 1) -> np.ndarray:
    """First-order scaled Scharr along x or y (exactly one order must be 1)."""
    assert (x_order, y_order) in ((1, 0), (0, 1))
    deriv, smooth = scharr_kernels(sigma_size)
    if x_order == 1:
        return separable_filter(img, kx=deriv, ky=smooth)
    return separable_filter(img, kx=smooth, ky=deriv)
