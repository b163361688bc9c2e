"""Kernel 6 (`describe_pallas`): orientation + M-LDB for the keypoint slots
of one frame, read from that frame's padded (L, H0, W0) level stacks, with
its plain PyTorch twin (counterpart of the JAX package's
`akaze_tpu/kernels/describe_pallas.py`, the per-keypoint describe behind
`describe(..., backend="pallas")`).

It keeps the JAX kernel's arithmetic: the Cephes atan2, the first-max
window, floor(x + 0.5) then the clip to the level, the bit order, and its
cell means mean_mat^T . samples with a bit set where mean_a - mean_b > 0
(written mean_a > mean_b: the same bits); windows and cells are summed in
the order of `csrc/describe.cu` (kernel and twin alike, see
`kernels/describe.py`).  Samples are read in place from the level
plane (the TPU kernel's tile-aligned DMA window and one-hot matmul sampling
are not carried over), so coordinates are level coordinates, not window
coordinates.  Dead slots write a zero angle and zero words.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics, round_half_up
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.describe import _CHANNELS, describe_from_samples, keypoint_geometry, launch, zero_invalid

if TYPE_CHECKING:  # frontend/describe.py imports this module
    from akaze_tpu_torch.frontend.describe import DescribeStatics


def describe_pallas_plain(kps: Keypoints, stacks: dict, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """(angles (M,) f32, descriptors (M, W) int32) in plain PyTorch."""
    kpf, _ = keypoint_geometry(kps, ss)
    planes = [stacks[k] for k in _CHANNELS]
    L, H0, W0 = planes[0].shape
    xf, yf, sc = kpf[:, 0:1], kpf[:, 1:2], kpf[:, 2:3]
    base = kps.class_id[:, None].long() * (H0 * W0)

    def sample(channels, offx, offy):
        ix = torch.minimum(torch.clamp(round_half_up(xf + offx * sc), min=0), kpf[:, 3:4].to(torch.int32))
        iy = torch.minimum(torch.clamp(round_half_up(yf + offy * sc), min=0), kpf[:, 4:5].to(torch.int32))
        idx = base + iy.long() * W0 + ix.long()
        return [planes[c].reshape(-1)[idx] for c in channels]

    angle, words = describe_from_samples(sample, ds, kps.x.device)
    return zero_invalid(angle, words, kps.valid)


def describe_pallas(kps: Keypoints, stacks: dict, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """Kernel 6 on CUDA tensors (kernel 3's `describe_kernel` over one
    frame's padded stacks), its plain twin on CPU tensors.  kps: one frame's
    (M,) keypoints; stacks: "Lt", "Lx", "Ly" as padded (L, H0, W0).  Returns
    (angles (M,), descriptors (M, W))."""
    if kps.x.device.type == "cpu":
        return describe_pallas_plain(kps, stacks, ss, ds)
    _build.require_cuda(kps.x, "describe_pallas")
    return launch("describe_pallas", kps, [tuple(stacks[k] for k in _CHANNELS)], ss, ds, single=True)
