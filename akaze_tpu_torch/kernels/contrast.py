"""The contrast factor of a batch of |grad| planes: two CUDA launches per
call (`csrc/contrast.cu`) on CUDA tensors, the plain form
(`frontend/scale_space.contrast_factor_from_modg`) on CPU tensors.

The input is kernel 1's modg, a contiguous (B, H, W) float32 batch; the
result is the (B,) float32 factor k of each frame: the gradient magnitude at
the `contrast_percentile` of a histogram of the frame's interior pixels into
`contrast_nbins` bins, or `contrast_fallback`.  The kernel's k equals the
plain form's on the card bit for bit while a frame holds fewer than 2^24
interior pixels (beyond, the plain form's float32 cumulative sum rounds and
the kernel's stays exact).  The stage makes no host sync.

`path_counts()` reads the latest kernel call's frames by path: "percentile"
(k from the histogram) and "fallback" (hmax <= 0, or no bin reached the
threshold).  Reading it waits for the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
from akaze_tpu_torch.kernels import _build

#: Most bins the kernel takes (its per-warp copies fill 192 KB of shared memory).
MAX_BINS = 6144
PATHS = ("percentile", "fallback")
#: Blocks per SM a call aims at (two waves at the four each SM holds), and the
#: fewest pixels a block's tile takes.
BLOCKS_PER_SM = 8
MIN_TILE_PX = 8192

_latest_paths = None  # the latest call's (2,) int32 device sums, in PATHS order


def tile_count(B: int, H: int, W: int, sms: int) -> int:
    """Blocks per frame: enough for BLOCKS_PER_SM on every SM over the batch,
    each with at least MIN_TILE_PX pixels of its frame."""
    return max(1, min(-(-BLOCKS_PER_SM * sms // B), (H - 2) * W // MIN_TILE_PX))


def _check(modg: torch.Tensor) -> None:
    if modg.dtype != torch.float32 or modg.ndim != 3 or not modg.is_contiguous():
        raise ValueError(f"contrast_factor: expects a contiguous float32 (B, H, W) tensor, got {modg.dtype} "
                         f"{tuple(modg.shape)}{'' if modg.is_contiguous() else ' (not contiguous)'}")


def contrast_factor(modg: torch.Tensor, config: AkazeConfig) -> torch.Tensor:
    """(B,) contrast factors of (B, H, W) modg planes: the kernel on CUDA
    tensors, the plain form on CPU tensors."""
    global _latest_paths
    _check(modg)
    if modg.device.type == "cpu":
        return contrast_factor_from_modg(modg, config)
    _build.require_cuda(modg, "contrast_factor")
    B, H, W = modg.shape
    nbins = config.contrast_nbins
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"contrast_factor: contrast_nbins must lie in 1..{MAX_BINS}, got {nbins}")
    if H < 3 or W < 3 or H * W >= 2**31 or B > 65535:
        raise ValueError(f"contrast_factor: the kernel takes 3 <= H, W, H * W < 2^31 and B <= 65,535, "
                         f"got {tuple(modg.shape)}")
    k = torch.empty(B, dtype=torch.float32, device=modg.device)
    if B == 0:
        return k
    tiles = tile_count(B, H, W, torch.cuda.get_device_properties(modg.device).multi_processor_count)
    ws = torch.empty(2 + B + B * nbins + B * tiles, dtype=torch.int32, device=modg.device)
    P_, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function("contrast", "contrast_factor", [P_, I, I, I, I, I, F, F, F, P_, P_, P_])
    # The plain form on the card divides by the host scalar nbins as a
    # product with its float reciprocal.
    inv_nbins = float(np.float32(1.0) / np.float32(nbins))
    with torch.cuda.device(modg.device):
        err = fn(modg.data_ptr(), B, H, W, tiles, nbins, config.contrast_percentile, config.contrast_fallback,
                 inv_nbins, ws.data_ptr(), k.data_ptr(), _build.stream_of(modg))
    _build.check("contrast", err, "contrast_factor")
    _build.launches["contrast"] += 1
    _latest_paths = ws[:2]
    return k


def path_counts() -> dict | None:
    """{"percentile", "fallback"}: frames by path in the latest kernel call
    (None before the first); waits for the card."""
    if _latest_paths is None:
        return None
    return dict(zip(PATHS, _latest_paths.tolist()))
