"""Kernel 6 (`describe_pallas`): orientation + M-LDB for the keypoint slots
of one frame, read from that frame's padded (L, H0, W0) level stacks, with
its plain PyTorch twin (counterpart of the JAX package's
`akaze_tpu/kernels/describe_pallas.py`, the per-keypoint describe behind
`describe(..., backend="pallas")`).

It keeps the JAX kernel's arithmetic: the Cephes atan2, the first-max
window, floor(x + 0.5) then the clip to the level, the bit order, and its
cell means mean_mat^T . samples (summed over each cell's members in sample
order, kernel and twin alike) with a bit set where mean_a - mean_b > 0
(written mean_a > mean_b: the same bits).  Samples are read in place from the level
plane (the TPU kernel's tile-aligned DMA window and one-hot matmul sampling
are not carried over), so coordinates are level coordinates, not window
coordinates.  Dead slots write a zero angle and zero words.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics, per_level_scale, round_half_up
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.describe import _CHANNELS, _MAX_CELLS, _MAX_ORI, _MAX_SAMP, _MAX_WIN, _tables
from akaze_tpu_torch.kernels.describe import describe_from_samples, zero_invalid

if TYPE_CHECKING:  # frontend/describe.py imports this module
    from akaze_tpu_torch.frontend.describe import DescribeStatics


def _geometry(kps: Keypoints, ss: ScaleSpaceStatics):
    """kpf (M, 5) f32 = (xf, yf, scale, xmax, ymax), kpi (M, 2) i32 = (level,
    valid) of one frame's (M,) keypoints."""
    dev = kps.x.device
    lvl = kps.class_id.long()
    table = lambda a: torch.as_tensor(a, device=dev).to(torch.float32)[lvl]
    ratio = table(ss.ratios)
    kpf = torch.stack([kps.x / ratio, kps.y / ratio, table(per_level_scale(ss)),
                       table(ss.widths - 1), table(ss.heights - 1)], dim=1)
    kpi = torch.stack([lvl, kps.valid.long()], dim=1).to(torch.int32)
    return kpf.contiguous(), kpi.contiguous()


def describe_pallas_plain(kps: Keypoints, stacks: dict, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """(angles (M,) f32, descriptors (M, W) int32) in plain PyTorch."""
    kpf, kpi = _geometry(kps, ss)
    planes = [stacks[k] for k in _CHANNELS]
    L, H0, W0 = planes[0].shape
    xf, yf, sc = kpf[:, 0:1], kpf[:, 1:2], kpf[:, 2:3]
    base = kpi[:, 0:1].long() * (H0 * W0)

    def sample(channels, offx, offy):
        ix = torch.minimum(torch.clamp(round_half_up(xf + offx * sc), min=0), kpf[:, 3:4].to(torch.int32))
        iy = torch.minimum(torch.clamp(round_half_up(yf + offy * sc), min=0), kpf[:, 4:5].to(torch.int32))
        idx = base + iy.long() * W0 + ix.long()
        return [planes[c].reshape(-1)[idx] for c in channels]

    angle, words = describe_from_samples(sample, ds, kps.x.device)
    return zero_invalid(angle, words, kps.valid)


def describe_pallas(kps: Keypoints, stacks: dict, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """Kernel 6 on CUDA tensors (one warp per slot), its plain twin on CPU
    tensors.  kps: one frame's (M,) keypoints; stacks: "Lt", "Lx", "Ly" as
    padded (L, H0, W0).  Returns (angles (M,), descriptors (M, W))."""
    if kps.x.device.type == "cpu":
        return describe_pallas_plain(kps, stacks, ss, ds)
    _build.require_cuda(kps.x, "describe_pallas")
    dev = kps.x.device
    planes = [stacks[k] for k in _CHANNELS]
    for p in planes:
        if (p.dtype != torch.float32 or p.ndim != 3 or not p.is_contiguous() or p.device != dev
                or p.shape != planes[0].shape):
            raise ValueError(f"describe_pallas: Lt/Lx/Ly must be contiguous float32 (L, H0, W0) stacks on {dev}")
    ftab, itab, sz = _tables(ds, dev)
    if (sz["n_ori"] > _MAX_ORI or sz["n_win"] > _MAX_WIN or sz["n_samp"] > _MAX_SAMP
            or sz["n_cells"] > _MAX_CELLS):
        raise ValueError(f"describe_pallas: tables {sz} exceed the kernel's capacities")
    kpf, kpi = _geometry(kps, ss)
    M = kps.x.shape[0]
    nwords = ds.config.descriptor_words
    angles = torch.empty((M,), dtype=torch.float32, device=dev)
    descs = torch.empty((M, nwords), dtype=torch.int32, device=dev)
    _, H0, W0 = planes[0].shape
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("describe", "describe_single", [
        P, P, P, I, I, I, P, P, P, P, I, I, I, I, I, I, P, P, P,
    ])
    with torch.cuda.device(dev):
        err = fn(*(p.data_ptr() for p in planes), H0, W0, M, kpf.data_ptr(), kpi.data_ptr(),
                 ftab.data_ptr(), itab.data_ptr(), sz["n_ori"], sz["n_win"], sz["n_samp"],
                 sz["n_cells"], sz["n_bits"], nwords, angles.data_ptr(), descs.data_ptr(),
                 _build.stream_of(kps.x))
    _build.check("describe", err, "describe_pallas")
    _build.launches["describe_pallas"] += 1
    return angles, descs
