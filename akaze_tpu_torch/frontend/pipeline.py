"""The AKAZE front end of the port: frames in, `Features` out
(counterpart of the JAX package's `akaze_tpu/frontend/pipeline.py`).

    feats = extract_batch(frames)  # (B, H, W) -> Features, (B, M) leaves
    feats = extract_fn(img, config)  # one (H, W) tensor, per-level build

`extract_batch` runs on "cuda" through the hand-written kernels (1-2, then
3 or, with describe_backend "xla" / "pallas", 7); device="cpu" runs the
plain PyTorch twins.  `extract_fn` runs on its tensor's device through
kernels 1, 5 and 7.  Importing this module pins float32 on the GPU: TF32 is
turned off for matrix products and for cuDNN convolutions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.core.types import Features
from akaze_tpu_torch.frontend.describe import DescribeStatics, describe, describe_batched
from akaze_tpu_torch.frontend.detect import detect, detect_dense, find_candidates_oct
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics
from akaze_tpu_torch.kernels.fed import build_scale_space, build_scale_space_levels
from akaze_tpu_torch.utils.profiling import check_no_nan

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=32)
def _statics(width: int, height: int, config: AkazeConfig):
    ss = ScaleSpaceStatics(width, height, config)
    return ss, DescribeStatics(config, ss)


def _as_unit_gray(imgs: torch.Tensor) -> torch.Tensor:
    """Integer images normalise to float32 in [0, 1]; float images pass
    through as float32."""
    if not imgs.dtype.is_floating_point:
        return imgs.to(torch.float32) / float(torch.iinfo(imgs.dtype).max)
    return imgs.to(torch.float32)


def _as_tensor(frames, device: torch.device) -> torch.Tensor:
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    return frames.to(device)


def extract_batch_fn(imgs: torch.Tensor, config: AkazeConfig, plain: bool = False) -> Features:
    """Batched pipeline on a (B, H, W) tensor on its device (the JAX
    package's TPU branch): per-octave scale space (kernels 1-2), detection
    (PyTorch ops), description on the branch `config.describe_backend`
    picks (kernel 3, or kernel 7 and PyTorch ops).  plain=True runs the
    plain twins on any device (for comparisons)."""
    imgs = _as_unit_gray(imgs).contiguous()
    height, width = imgs.shape[-2], imgs.shape[-1]
    ss, ds = _statics(width, height, config)
    stacks = build_scale_space(imgs, ss, plain=plain)
    cand = find_candidates_oct(stacks["oct"], ss)
    kps = detect(cand, stacks["oct"], ss)
    return describe_batched(kps, stacks["lvl_oct"], ss, ds, plain=plain)


def extract_fn(img: torch.Tensor, config: AkazeConfig, plain: bool = False) -> Features:
    """One (H, W) tensor on its device -> Features with (M,) leaves, by the
    JAX package's per-level branch (the one it runs off the TPU): the
    per-level build (kernel 1, the contrast factor, kernel 5 per level) into
    padded (L, H0, W0) stacks, dense detection on Ldet, and the non-fused
    describe (kernel 7).  plain=True runs the plain twins on any device."""
    if img.ndim != 2:
        raise ValueError(f"extract_fn expects a single (H, W) grayscale image, got shape "
                         f"{tuple(img.shape)}; use extract_batch_fn for batches")
    img = _as_unit_gray(img).contiguous()
    ss, ds = _statics(img.shape[1], img.shape[0], config)
    stacks = build_scale_space_levels(img[None], ss, plain=plain)
    kps = detect_dense(stacks["Ldet"], ss).index(0)
    return describe(kps, {k: stacks[k][0] for k in ("Lt", "Lx", "Ly")}, ss, ds, plain=plain)


def extract_batch(frames, config: AkazeConfig | None = None, device="cuda") -> Features:
    """(B, H, W) frames (tensor or numpy; float in [0, 1] or integer) ->
    Features with (B, M) leaves on `device`."""
    config = config or AkazeConfig()
    if frames.ndim != 3:
        raise ValueError(f"extract_batch expects (B, H, W) frames, got shape {tuple(frames.shape)}")
    feats = extract_batch_fn(_as_tensor(frames, resolve_device(device)), config)
    kp = feats.keypoints
    check_no_nan("extract_batch", kp.x, kp.y, kp.response, kp.size, kp.angle)
    return feats


def extract(img, config: AkazeConfig | None = None, device="cuda") -> Features:
    """One (H, W) grayscale image -> Features with (M,) leaves, through
    `extract_batch` at B = 1 (the JAX package's TPU branch)."""
    if img.ndim != 2:
        raise ValueError(f"extract expects a single (H, W) grayscale image, got shape "
                         f"{tuple(img.shape)}; use extract_batch for batches")
    return extract_batch(img[None], config, device).index(0)
