"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

Imports neither JAX nor the JAX package, so the GPU tests that use it run
on a machine without JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from akaze_tpu_torch.kernels import fed


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row Hamming distance of (..., W) 32-bit descriptor words."""
    a = np.ascontiguousarray(a).view(np.uint32)
    b = np.ascontiguousarray(b).view(np.uint32)
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1)


def wrapped_angle_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture
def cuda():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def pair_keypoints(ref: dict, got: dict, tol: float = 0.01):
    """Pair each valid reference keypoint with a valid port keypoint of the
    same class_id within `tol` px.  ref/got: dicts of one frame's numpy
    keypoint fields plus "descriptors".  Returns (paired fraction, Hamming
    distances of the pairs)."""
    rv = np.nonzero(ref["valid"])[0]
    gv = got["valid"]
    hams = []
    for i in rv:
        c = np.nonzero(gv & (got["class_id"] == ref["class_id"][i]))[0]
        if len(c) == 0:
            continue
        d = np.hypot(got["x"][c] - ref["x"][i], got["y"][c] - ref["y"][i])
        if d.min() < tol:
            hams.append(int(hamming(ref["descriptors"][i], got["descriptors"][c[d.argmin()]])))
    return len(hams) / max(1, len(rv)), np.asarray(hams)


def custom_plan(specs, h: int, w: int, first: bool, tile, fuse: bool) -> tuple:
    """A level-chain plan that `fed.level_plan` does not choose: every level
    of the octave `specs` on (h, w) planes run on `tile`, its detect cascade
    in the level's one launch (fuse) or in a launch of its own, each halo as
    small as its stages allow."""
    plans = []
    for i, spec in enumerate(specs):
        n, reach = len(spec.taus), 2 * spec.sigma_size + 1
        detect = fed._launch("detect", h, w, tile, reach)
        if first and i == 0:
            launches = (detect,)
        elif fuse:
            launches = (fed._launch("level", h, w, tile, max(n + 3, reach + 2), n),)
        else:
            launches = (fed._launch("diffuse", h, w, tile, n + 3, n), detect)
        plans.append(fed.LevelPlan("tiled", launches))
    return tuple(plans)
