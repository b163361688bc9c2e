"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

Imports neither JAX nor the JAX package, so the GPU tests that use it run
on a machine without JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch


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
