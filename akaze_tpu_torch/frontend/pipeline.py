"""The AKAZE front end of the port: frames in, `Features` out
(counterpart of the JAX package's `akaze_tpu/frontend/pipeline.py`).

    feats = extract_batch(frames)  # (B, H, W) -> Features, (B, M) leaves

runs on "cuda" through the four hand-written kernels; device="cpu" runs
the plain PyTorch twins.  Importing this module pins float32 on the GPU:
TF32 is turned off for matrix products and for cuDNN convolutions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.core.types import Features
from akaze_tpu_torch.frontend.describe import DescribeStatics
from akaze_tpu_torch.frontend.detect import detect, find_candidates_oct
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics
from akaze_tpu_torch.kernels.describe import describe, describe_plain
from akaze_tpu_torch.kernels.fed import build_scale_space

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
    """Batched pipeline on a (B, H, W) tensor on its device: scale space
    (kernels 1-2), detection (PyTorch ops), description (kernel 3).
    plain=True runs the plain twins on any device (for comparisons)."""
    imgs = _as_unit_gray(imgs).contiguous()
    height, width = imgs.shape[-2], imgs.shape[-1]
    ss, ds = _statics(width, height, config)
    stacks = build_scale_space(imgs, ss, plain=plain)
    cand = find_candidates_oct(stacks["oct"], ss)
    kps = detect(cand, stacks["oct"], ss)
    angles, descriptors = (describe_plain if plain else describe)(kps, stacks["lvl_oct"], ss, ds)
    return Features(dataclasses.replace(kps, angle=angles), descriptors)


def extract_batch(frames, config: AkazeConfig | None = None, device="cuda") -> Features:
    """(B, H, W) frames (tensor or numpy; float in [0, 1] or integer) ->
    Features with (B, M) leaves on `device`."""
    config = config or AkazeConfig()
    if frames.ndim != 3:
        raise ValueError(f"extract_batch expects (B, H, W) frames, got shape {tuple(frames.shape)}")
    return extract_batch_fn(_as_tensor(frames, resolve_device(device)), config)


def extract(img, config: AkazeConfig | None = None, device="cuda") -> Features:
    """One (H, W) grayscale image -> Features with (M,) leaves."""
    if img.ndim != 2:
        raise ValueError(f"extract expects a single (H, W) grayscale image, got shape "
                         f"{tuple(img.shape)}; use extract_batch for batches")
    return extract_batch(img[None], config, device).index(0)
