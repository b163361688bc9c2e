"""Kernel 3 (`describe`): orientation + M-LDB for every valid keypoint
slot, with its plain PyTorch twin (counterpart of the JAX package's
`akaze_tpu/kernels/describe_fused.py`).

Both versions share the per-keypoint geometry prep (`keypoint_geometry`):
level coordinates xf = x / ratio, the level's sampling scale and clip
bounds, and where its planes live (octave group, level within the octave,
frame).  The TPU kernel's aligned DMA windows are not carried over: samples
are read straight from the level planes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING

import numpy as np
import torch

from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics, per_level_scale, round_half_up
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.fed import octave_groups

if TYPE_CHECKING:  # frontend/describe.py imports this module
    from akaze_tpu_torch.frontend.describe import DescribeStatics

TWO_PI = float(np.float32(2.0 * math.pi))
_PI = float(np.float32(math.pi))
# Compile-time capacities of csrc/describe.cu.
_MAXG, _MAX_ORI, _MAX_WIN, _MAX_SAMP, _MAX_CELLS = 8, 128, 64, 448, 32


def atan2_cephes(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The Cephes-style float32 atan2 of the TPU kernel (error ~1e-7 rad)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    one = torch.ones_like(ax)
    t = ay / torch.where(ax > 0, ax, one)
    big = t > 2.414213562373095  # tan(3pi/8)
    mid = (t > 0.4142135623730951) & ~big
    zero = torch.zeros_like(t)
    base = torch.where(big, zero + _PI / 2, torch.where(mid, zero + _PI / 4, zero))
    safe_t = torch.where(big, torch.maximum(t, one), t)
    tr = torch.where(big, -1.0 / safe_t, torch.where(mid, (t - 1.0) / (t + 1.0), t))
    z = tr * tr
    p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z - 3.33329491539e-1
    q = base + tr + tr * z * p
    q = torch.where(ax > 0, q, zero + _PI / 2)
    q = torch.where((ax == 0) & (ay == 0), zero, q)
    q = torch.where(x < 0, _PI - q, q)
    return torch.where(y < 0, -q, q)


def mod_2pi(a: torch.Tensor) -> torch.Tensor:
    """jnp.mod(a, 2 pi): the remainder takes the divisor's sign."""
    r = torch.fmod(a, TWO_PI)
    return torch.where(r < 0, r + TWO_PI, r)


def keypoint_geometry(kps: Keypoints, ss: ScaleSpaceStatics):
    """Flat per-keypoint prep: kpf (N, 5) f32 = (xf, yf, scale, xmax, ymax)
    and kpi (N, 4) i32 = (octave group, level in group, frame, valid)."""
    B, M = kps.x.shape
    dev = kps.x.device
    L = ss.num_levels
    grp_of = np.zeros(L, np.int64)
    l0_of = np.zeros(L, np.int64)
    for g, (l0, n, _, _) in enumerate(octave_groups(ss)):
        grp_of[l0 : l0 + n] = g
        l0_of[l0 : l0 + n] = l0
    lvl = kps.class_id.reshape(-1).long()
    table = lambda a, dtype: torch.as_tensor(a, device=dev).to(dtype)[lvl]
    xf = kps.x.reshape(-1) / table(ss.ratios, torch.float32)
    yf = kps.y.reshape(-1) / table(ss.ratios, torch.float32)
    kpf = torch.stack([
        xf, yf,
        table(per_level_scale(ss), torch.float32),
        table(ss.widths - 1, torch.float32),
        table(ss.heights - 1, torch.float32),
    ], dim=1)
    frame = torch.arange(B, device=dev).repeat_interleave(M)
    kpi = torch.stack([
        table(grp_of, torch.int64), lvl - table(l0_of, torch.int64), frame,
        kps.valid.reshape(-1).long(),
    ], dim=1).to(torch.int32)
    return kpf.contiguous(), kpi.contiguous()


def _sample(planes, kpf, kpi, offx, offy):
    """Nearest-pixel samples at round_half_up(xf + off * scale), clipped to
    the level: planes are per-group (n, B, h, w) stacks; offx/offy (N, S)
    or (S,).  Returns one (N, S) tensor per stack in `planes`' last axis."""
    xf, yf, sc = kpf[:, 0:1], kpf[:, 1:2], kpf[:, 2:3]
    ix = torch.minimum(torch.clamp(round_half_up(xf + offx * sc), min=0), kpf[:, 3:4].to(torch.int32))
    iy = torch.minimum(torch.clamp(round_half_up(yf + offy * sc), min=0), kpf[:, 4:5].to(torch.int32))
    grp, li, frame = kpi[:, 0:1].long(), kpi[:, 1:2].long(), kpi[:, 2:3].long()
    outs = None
    for g, stacks in enumerate(planes):
        n, B, h, w = stacks[0].shape
        sel = grp == g
        idx = ((li * B + frame) * h + iy.long()) * w + ix.long()
        idx = torch.where(sel, idx, torch.zeros_like(idx))
        vals = [s.reshape(-1)[idx] for s in stacks]
        outs = vals if outs is None else [torch.where(sel, v, o) for v, o in zip(vals, outs)]
    return outs


@functools.lru_cache(maxsize=8)
def _cell_members(ds: DescribeStatics):
    """Per grid: the (C, m) member sample indices of its cells in increasing
    order (the cells of a grid are equal squares) and the (C,) mean
    weights, as csrc/describe.cu sums them."""
    out = []
    for grid in ds.grids:
        mm = grid["mean_mat"]
        idx = np.stack([np.nonzero(mm[:, c])[0] for c in range(mm.shape[1])])
        out.append((idx, mm[idx[:, 0], np.arange(mm.shape[1])].astype(np.float32)))
    return out


def _cell_means_in_member_order(chans: torch.Tensor, idx, cw) -> torch.Tensor:
    """(3, N, S) samples -> (3, N, C) cell means as kernels 3 and 6 sum
    them: per cell, acc = acc + sample * weight over its members in
    increasing sample order, from 0."""
    idx, cw = torch.as_tensor(idx, device=chans.device), torch.as_tensor(cw, device=chans.device)
    acc = torch.zeros(chans.shape[:2] + (idx.shape[0],), dtype=chans.dtype, device=chans.device)
    for j in range(idx.shape[1]):
        acc = acc + chans[:, :, idx[:, j]] * cw
    return acc


def describe_from_samples(sample, ds: DescribeStatics, dev: torch.device, xla: bool = False):
    """Orientation + M-LDB of N keypoints from a sampler, in plain PyTorch.

    sample(channels, offx, offy) returns, for each channel index (0 Lt,
    1 Lx, 2 Ly), the (N, S) nearest-pixel samples at round_half_up(xf +
    off * scale) of each keypoint, clipped to its level; offx/offy are (S,)
    or (N, S).  By default the arithmetic of kernels 3 and 6: the Cephes
    atan2 and cell means summed in member order.  xla=True is the JAX
    package's XLA describe: torch.atan2 and cell means as one product with
    the mean matrix.  A bit is set where mean_a > mean_b.
    Returns (angles (N,), words (N, W) int32)."""
    atan2 = torch.atan2 if xla else atan2_cephes
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # Orientation.
    sx_, sy_ = sample((1, 2), t(ds.ori_di), t(ds.ori_dj))
    w = t(ds.ori_w)
    rx = w * sx_
    ry = w * sy_
    ang = mod_2pi(atan2(ry, rx))[:, None, :]  # (N, 1, S)
    lo, hi = t(ds.win_lo)[:, None], t(ds.win_hi)[:, None]
    wrap = torch.as_tensor(ds.win_wrap, device=dev)[:, None]
    inside = torch.where(wrap, (ang > lo) | (ang < hi - TWO_PI), (ang > lo) & (ang < hi))
    zero = torch.zeros((), device=dev)
    sum_x = torch.where(inside, rx[:, None, :], zero).sum(-1)
    sum_y = torch.where(inside, ry[:, None, :], zero).sum(-1)
    norm = sum_x * sum_x + sum_y * sum_y
    best = torch.argmax(norm, dim=-1, keepdim=True)  # first max
    angle = mod_2pi(atan2(sum_y.gather(1, best)[:, 0], sum_x.gather(1, best)[:, 0]))

    # M-LDB.
    co = torch.cos(angle)[:, None]
    si = torch.sin(angle)[:, None]
    offk, offl = t(ds.all_offk), t(ds.all_offl)
    syo = offl * co + offk * si
    sxo = -offl * si + offk * co
    ri, gx, gy = sample((0, 1, 2), sxo, syo)
    dx = gx * co + gy * si
    dy = -gx * si + gy * co
    chans = torch.stack([ri, dx, dy])
    bits = []
    for grid, members in zip(ds.grids, _cell_members(ds)):
        if xla:
            means = torch.stack([ch @ t(grid["mean_mat"]) for ch in chans])
        else:
            means = _cell_means_in_member_order(chans, *members)
        pa = torch.as_tensor(grid["pa"], device=dev).long()
        pb = torch.as_tensor(grid["pb"], device=dev).long()
        bits.extend(means[:, :, pa] > means[:, :, pb])
    allbits = torch.cat(bits, dim=1)
    nwords = ds.config.descriptor_words
    allbits = torch.nn.functional.pad(allbits, (0, nwords * 32 - allbits.shape[1]))
    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64, device=dev)
    words = (allbits.reshape(-1, nwords, 32).long() * weights).sum(-1)
    return angle, torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def zero_invalid(angle: torch.Tensor, words: torch.Tensor, valid: torch.Tensor):
    """Angles and descriptor words of invalid slots set to zero."""
    return (torch.where(valid, angle, torch.zeros_like(angle)),
            torch.where(valid[..., None], words, torch.zeros_like(words)))


_CHANNELS = ("Lt", "Lx", "Ly")


def describe_plain(kps: Keypoints, lvl_oct, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """(angles (B, M) f32, descriptors (B, M, W) int32) in plain PyTorch."""
    B, M = kps.x.shape
    kpf, kpi = keypoint_geometry(kps, ss)

    def sample(channels, offx, offy):
        planes = [tuple(o[_CHANNELS[c]] for c in channels) for o in lvl_oct]
        return _sample(planes, kpf, kpi, offx, offy)

    angle, words = describe_from_samples(sample, ds, kps.x.device)
    angle, words = zero_invalid(angle, words, kps.valid.reshape(-1))
    return angle.reshape(B, M), words.reshape(B, M, -1)


@functools.lru_cache(maxsize=8)
def _host_tables(ds: DescribeStatics):
    """Flat float and int tables of csrc/describe.cu (see its layout note)."""
    cells, bit_a, bit_b = [], [], []
    n_cells = sum(g["mean_mat"].shape[1] for g in ds.grids)
    c0 = 0
    for grid, (idx, cw) in zip(ds.grids, _cell_members(ds)):
        cells.extend(zip(idx, cw))
        for ch in range(3):
            bit_a.extend(ch * n_cells + c0 + grid["pa"])
            bit_b.extend(ch * n_cells + c0 + grid["pb"])
        c0 += len(cw)
    ftab = np.concatenate([
        ds.ori_di, ds.ori_dj, ds.ori_w, ds.win_lo, ds.win_hi,
        ds.win_wrap.astype(np.float32), ds.all_offk, ds.all_offl,
        np.array([inv for _, inv in cells], np.float32),
    ]).astype(np.float32)
    start = np.cumsum([0] + [len(m) for m, _ in cells])
    itab = np.concatenate([start, *[m for m, _ in cells], bit_a, bit_b]).astype(np.int32)
    sizes = dict(n_ori=len(ds.ori_di), n_win=len(ds.win_lo), n_samp=ds.n_samples,
                 n_cells=n_cells, n_bits=len(bit_a))
    return ftab, itab, sizes


@functools.lru_cache(maxsize=8)
def _tables(ds: DescribeStatics, device: torch.device):
    ftab, itab, sizes = _host_tables(ds)
    return torch.as_tensor(ftab, device=device), torch.as_tensor(itab, device=device), sizes


def describe(kps: Keypoints, lvl_oct, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """Kernel 3 on CUDA tensors (one warp per keypoint slot), its plain
    twin on CPU tensors.  Returns (angles (B, M), descriptors (B, M, W))."""
    if kps.x.device.type == "cpu":
        return describe_plain(kps, lvl_oct, ss, ds)
    _build.require_cuda(kps.x, "describe")
    B, M = kps.x.shape
    dev = kps.x.device
    kpf, kpi = keypoint_geometry(kps, ss)
    ftab, itab, sz = _tables(ds, dev)
    if (len(lvl_oct) > _MAXG or sz["n_ori"] > _MAX_ORI or sz["n_win"] > _MAX_WIN
            or sz["n_samp"] > _MAX_SAMP or sz["n_cells"] > _MAX_CELLS):
        raise ValueError(f"describe: tables {sz} exceed the kernel's capacities")
    planes, gh, gw = [], [], []
    for o in lvl_oct:
        for key in ("Lt", "Lx", "Ly"):
            a = o[key]
            if a.dtype != torch.float32 or not a.is_contiguous() or a.device != dev or a.shape[1] != B:
                raise ValueError(f"describe: {key} must be a contiguous float32 (n, B, h, w) stack on {dev}")
            planes.append(a.data_ptr())
        gh.append(o["Lt"].shape[2])
        gw.append(o["Lt"].shape[3])
    nwords = ds.config.descriptor_words
    angles = torch.empty((B, M), dtype=torch.float32, device=dev)
    descs = torch.empty((B, M, nwords), dtype=torch.int32, device=dev)
    G = len(lvl_oct)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("describe", "describe", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(I), ctypes.POINTER(I), I, I, I,
        P, P, P, P, I, I, I, I, I, I, P, P, P,
    ])
    with torch.cuda.device(dev):
        err = fn((P * len(planes))(*planes), (I * G)(*gh), (I * G)(*gw), G, B, B * M,
                 kpf.data_ptr(), kpi.data_ptr(), ftab.data_ptr(), itab.data_ptr(),
                 sz["n_ori"], sz["n_win"], sz["n_samp"], sz["n_cells"], sz["n_bits"], nwords,
                 angles.data_ptr(), descs.data_ptr(), _build.stream_of(kps.x))
    _build.check("describe", err, "describe")
    _build.launches["describe"] += 1
    return angles, descs
