"""Kernel 3 (`describe`): orientation + M-LDB for every valid keypoint
slot, with its plain PyTorch twin (counterpart of the JAX package's
`akaze_tpu/kernels/describe_fused.py`), and the launcher that kernel 6
(`kernels/describe_single.py`) shares: both run `describe_kernel` of
`csrc/describe.cu`.

The twin (`describe_from_samples`) sums the orientation windows and the
cell means in the kernel's order: each window over WIN_SPLIT sample ranges,
each cell over parts of CELL_PART members, the partial sums then added in
order.  The kernel computes each slot's level geometry itself from the raw
keypoint fields and the per-level tables of `_level_args`, which the twin's
`keypoint_geometry` also reads.  The TPU kernel's aligned DMA windows are
not carried over: samples are read straight from the level planes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING

import numpy as np
import torch

from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics, round_half_up
from akaze_tpu_torch.kernels import _build

if TYPE_CHECKING:  # frontend/describe.py imports this module
    from akaze_tpu_torch.frontend.describe import DescribeStatics

#: csrc/describe.cu's decomposition: threads of a block (one slot at a
#: time), sample ranges per orientation window, members per cell task.
THREADS, WIN_SPLIT, CELL_PART = 128, 3, 25
# Compile-time capacities of csrc/describe.cu.
_MAXG, _MAXL, _MAX_ORI, _MAX_WIN, _MAX_SAMP, _MAX_CELLS, _MAX_TASKS, _MAX_TAB = (
    8, 32, 128, 64, 448, 32, 128, 3072)

TWO_PI = float(np.float32(2.0 * math.pi))
_PI = float(np.float32(math.pi))


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


def _level_args(ss: ScaleSpaceStatics, single: bool = False):
    """Per-level tables of the kernel: (4, L) float32 ratio, sampling scale,
    xmax = width - 1, ymax = height - 1, and (2, L) int32 octave group and
    plane index in the group: the per-octave (n, B, h, w) stacks, or with
    single=True one frame's padded (L, H0, W0) stacks (one group)."""
    if not single:
        return ss.level_f, ss.level_i
    return ss.level_f, np.stack([np.zeros(ss.num_levels), np.arange(ss.num_levels)]).astype(np.int32)


def keypoint_geometry(kps: Keypoints, ss: ScaleSpaceStatics):
    """Flat per-keypoint prep of (B, M) or (M,) keypoints: kpf (N, 5) f32 =
    (xf, yf, scale, xmax, ymax) and kpi (N, 4) i32 = (octave group, level in
    group, frame, valid)."""
    M = kps.x.shape[-1]
    tables = ss.on(kps.x.device)
    lvl = kps.class_id.reshape(-1).long()
    f, i = tables.level_f[lvl], tables.level_i[lvl]
    kpf = torch.stack([kps.x.reshape(-1) / f[:, 0], kps.y.reshape(-1) / f[:, 0], f[:, 1], f[:, 2], f[:, 3]], dim=1)
    frame = torch.arange(lvl.numel(), device=kps.x.device) // M
    kpi = torch.stack([i[:, 0], i[:, 1], frame, kps.valid.reshape(-1).long()], dim=1).to(torch.int32)
    return kpf, kpi


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


def _cell_means_in_member_order(chans: torch.Tensor, idx: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """(3, N, S) samples -> (3, N, C) cell means as kernels 3 and 6 sum
    them from a grid's (C, m) member indices and (C,) weights: each cell's
    members (increasing sample order) cut into parts of CELL_PART, each part
    summed acc = acc + sample * weight from 0, then the part sums added in
    part order."""
    mean = None
    for q0 in range(0, idx.shape[1], CELL_PART):
        acc = torch.zeros(chans.shape[:2] + (idx.shape[0],), dtype=chans.dtype, device=chans.device)
        for j in range(q0, min(idx.shape[1], q0 + CELL_PART)):
            acc = acc + chans[:, :, idx[:, j]] * cw
        mean = acc if mean is None else mean + acc
    return mean


def _window_sums(inside: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(N, n_win) sums of the (N, S) sample values r over the (N, n_win, S)
    window masks as kernels 3 and 6 take them: the samples cut into
    WIN_SPLIT ranges of ceil(S / WIN_SPLIT), each range summed in sample
    order from 0 (outside samples add 0), then the range sums added in
    range order."""
    S = r.shape[-1]
    n = -(-S // WIN_SPLIT)
    vals = torch.where(inside, r[:, None, :], torch.zeros((), dtype=r.dtype, device=r.device))
    vals = torch.nn.functional.pad(vals, (0, WIN_SPLIT * n - S)).reshape(*vals.shape[:2], WIN_SPLIT, n)
    acc = torch.zeros(vals.shape[:3], dtype=r.dtype, device=r.device)
    for k in range(n):
        acc = acc + vals[..., k]
    out = acc[..., 0]
    for j in range(1, WIN_SPLIT):
        out = out + acc[..., j]
    return out


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
    d = ds.on(dev)

    # Orientation.
    sx_, sy_ = sample((1, 2), d.ori_di, d.ori_dj)
    rx = d.ori_w * sx_
    ry = d.ori_w * sy_
    ang = mod_2pi(atan2(ry, rx))[:, None, :]  # (N, 1, S)
    lo, hi, wrap = d.win_lo[:, None], d.win_hi[:, None], d.win_wrap[:, None]
    inside = torch.where(wrap, (ang > lo) | (ang < hi - TWO_PI), (ang > lo) & (ang < hi))
    zero = torch.zeros((), device=dev)
    if xla:
        sum_x = torch.where(inside, rx[:, None, :], zero).sum(-1)
        sum_y = torch.where(inside, ry[:, None, :], zero).sum(-1)
    else:
        sum_x, sum_y = _window_sums(inside, rx), _window_sums(inside, ry)
    norm = sum_x * sum_x + sum_y * sum_y
    best = torch.argmax(norm, dim=-1, keepdim=True)  # first max
    angle = mod_2pi(atan2(sum_y.gather(1, best)[:, 0], sum_x.gather(1, best)[:, 0]))

    # M-LDB.
    co = torch.cos(angle)[:, None]
    si = torch.sin(angle)[:, None]
    syo = d.all_offl * co + d.all_offk * si
    sxo = -d.all_offl * si + d.all_offk * co
    ri, gx, gy = sample((0, 1, 2), sxo, syo)
    dx = gx * co + gy * si
    dy = -gx * si + gy * co
    chans = torch.stack([ri, dx, dy])
    bits = []
    for grid in d.grids:
        if xla:
            means = torch.stack([ch @ grid["mean_mat"] for ch in chans])
        else:
            means = _cell_means_in_member_order(chans, grid["members"], grid["weights"])
        bits.extend(means[:, :, grid["pa"]] > means[:, :, grid["pb"]])
    allbits = torch.cat(bits, dim=1)
    nwords = ds.config.descriptor_words
    allbits = torch.nn.functional.pad(allbits, (0, nwords * 32 - allbits.shape[1]))
    weights = 1 << torch.arange(32, dtype=torch.int64, device=dev)
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


def kernel_table(ds: DescribeStatics):
    """The int32 table of csrc/describe.cu (floats by their bits; see its
    layout note) and its sizes (n_ori, n_win, n_samp, n_cells, n_tasks,
    n_bits, n_words, n_tab), as numpy; `DescribeStatics.on` copies it."""
    cells, bits = [], []
    n_cells = sum(g["mean_mat"].shape[1] for g in ds.grids)
    c0 = 0
    for grid in ds.grids:
        cells.extend(zip(grid["members"], grid["weights"]))
        for ch in range(3):
            bits.extend((ch * n_cells + c0 + grid["pa"]) | ((ch * n_cells + c0 + grid["pb"]) << 16))
        c0 += len(grid["weights"])
    floats = np.concatenate([
        ds.ori_di, ds.ori_dj, ds.ori_w, ds.win_lo, ds.win_hi,
        ds.win_wrap.astype(np.float32), ds.all_offk, ds.all_offl,
        np.array([inv for _, inv in cells], np.float32),
    ]).astype(np.float32)
    start = np.cumsum([0] + [len(m) for m, _ in cells])
    parts = [-(-len(m) // CELL_PART) for m, _ in cells]
    first = np.cumsum([0] + parts)
    members = np.concatenate([m for m, _ in cells]).astype(np.uint16)
    members = np.pad(members, (0, len(members) % 2)).view(np.int32)
    tab = np.concatenate([floats.view(np.int32), start, first, np.repeat(np.arange(n_cells), parts),
                          bits, members]).astype(np.int32)
    tab = np.pad(tab, (0, -len(tab) % 4))
    sizes = (len(ds.ori_di), len(ds.win_lo), ds.n_samples, n_cells, int(first[-1]), len(bits),
             ds.config.descriptor_words, len(tab))
    return tab, sizes


def _level_c_args(ss: ScaleSpaceStatics, single: bool):
    lv_f, lv_i = _level_args(ss, single)
    if ss.num_levels > _MAXL:
        raise ValueError(f"describe: {ss.num_levels} levels exceed the kernel's {_MAXL}")
    return ((ctypes.c_float * lv_f.size)(*lv_f.ravel().tolist()),
            (ctypes.c_int * lv_i.size)(*lv_i.ravel().tolist()))


@functools.cache
def _entry():
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("describe", "describe", [
        ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(I), I, I, I, P, P, I,
        P, P, P, P, P, P, P, P, P,
    ])


def launch(what: str, kps: Keypoints, stacks, ss: ScaleSpaceStatics, ds: DescribeStatics, single: bool):
    """Run `describe_kernel` (csrc/describe.cu) on the slots of kps (x, y,
    class_id, valid: (B, M) or (M,) CUDA tensors) over `stacks`: per octave
    group (Lt, Lx, Ly) contiguous float32 (n, B, h, w) stacks, or with
    single=True one frame's padded (L, H0, W0) stacks as one group.  Adds
    one to `_build.launches[what]`.  Returns (angles (N,), words (N, W))
    for the N = B * M slots."""
    dev = kps.x.device
    fields = []
    for name, dtype in (("x", torch.float32), ("y", torch.float32), ("class_id", torch.int32),
                        ("valid", torch.bool)):
        f = getattr(kps, name)
        if f.dtype != dtype or f.device != dev or f.shape != kps.x.shape:
            raise ValueError(f"{what}: keypoint field {name} must be {dtype} {tuple(kps.x.shape)} on {dev}")
        fields.append(f.contiguous())
    B, M = (1, kps.x.shape[0]) if single else kps.x.shape
    if len(stacks) > _MAXG:
        raise ValueError(f"{what}: {len(stacks)} plane groups exceed the kernel's {_MAXG}")
    ndim = 3 if single else 4
    planes, gh, gw = [], [], []
    for group in stacks:
        for key, a in zip(_CHANNELS, group):
            if (a.dtype != torch.float32 or a.ndim != ndim or not a.is_contiguous() or a.device != dev
                    or a.shape != group[0].shape or (not single and a.shape[1] != B)):
                raise ValueError(f"{what}: {key} must be a contiguous float32 "
                                 f"{'(L, H0, W0)' if single else '(n, B, h, w)'} stack on {dev}")
            planes.append(a.data_ptr())
        gh.append(group[0].shape[-2])
        gw.append(group[0].shape[-1])
    d = ds.on(dev)
    caps = (_MAX_ORI, _MAX_WIN, _MAX_SAMP, _MAX_CELLS, _MAX_TASKS, None, 32, _MAX_TAB)
    if any(c is not None and n > c for n, c in zip(d.table_sizes, caps)):
        raise ValueError(f"describe: tables {d.table_sizes} exceed the kernel's capacities {caps}")
    lv_f, lv_i = _level_c_args(ss, single)
    nwords = ds.config.descriptor_words
    angles = torch.empty((B * M,), dtype=torch.float32, device=dev)
    descs = torch.empty((B * M, nwords), dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    G = len(stacks)
    with torch.cuda.device(dev):
        err = _entry()((P * len(planes))(*planes), (I * G)(*gh), (I * G)(*gw), G, B, M, lv_f, lv_i,
                       ss.num_levels, *(f.data_ptr() for f in fields), d.table.data_ptr(),
                       (I * len(d.table_sizes))(*d.table_sizes),
                       angles.data_ptr(), descs.data_ptr(), _build.stream_of(kps.x))
    _build.check("describe", err, what)
    _build.launches[what] += 1
    return angles, descs


def kernel_occupancy(device: torch.device) -> dict:
    """Threads per block, resident blocks per SM, SMs, static shared memory
    per block (bytes) and registers per thread of csrc/describe.cu's
    kernel on a CUDA device."""
    out = (ctypes.c_int * 5)()
    fn = _build.function("describe", "describe_occupancy", [ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(device):
        _build.check("describe", fn(out), "describe_occupancy")
    return dict(zip(("threads", "blocks_per_sm", "sms", "smem_bytes", "registers"), out))


def describe(kps: Keypoints, lvl_oct, ss: ScaleSpaceStatics, ds: DescribeStatics):
    """Kernel 3 on CUDA tensors, its plain twin on CPU tensors.  Returns
    (angles (B, M), descriptors (B, M, W))."""
    if kps.x.device.type == "cpu":
        return describe_plain(kps, lvl_oct, ss, ds)
    _build.require_cuda(kps.x, "describe")
    B, M = kps.x.shape
    angles, descs = launch("describe", kps, [tuple(o[k] for k in _CHANNELS) for o in lvl_oct], ss, ds,
                           single=False)
    return angles.reshape(B, M), descs.reshape(B, M, -1)
