"""Filter tap tables (own copy of the JAX package's golden `image.py`
helpers): the rounding rule, the normalised Gaussian and the scaled Scharr
kernels.  Every port filter takes its taps from here, so the constants are
the same float32 values the reference uses."""

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
