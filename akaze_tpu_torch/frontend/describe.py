"""The describe stage (counterpart of the JAX package's
`akaze_tpu/frontend/describe.py`): its statics, and the two ways it runs.

Orientation: SURF-style dominant direction from Gaussian-weighted Lx/Ly
samples on a discrete circle (109 offsets) and 42 sliding pi/3 windows.
M-LDB: per-cell means of (Lt, rotated Lx, rotated Ly) over 2x2/3x3/4x4
grids of a rotated pattern (441 unique offsets), compared pairwise into 486
bits, packed LSB-first into 16 words.

`describe_batched` reads `config.describe_backend` as the JAX package does
on a TPU: "auto" and "fused" run kernel 3 (when M % 64 == 0); "xla" and
"pallas" run the non-fused branch: the per-octave planes restacked into
padded level-major stacks, keypoint slots cut into chunks of 256, chunks
with no valid slot skipped, and for the live ones one (3, ph, pw) window
per slot cut by kernel 7 and described in PyTorch (`_describe_chunk`,
sampling by patch-local index where the JAX package used one-hot matmuls,
and the library atan2).  The single-frame `describe` runs that branch by
default and kernel 6 with backend="pallas".  The port zeroes the angle of
every invalid slot, where the JAX non-fused branch leaves it unspecified.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.core.types import Features, Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics, round_half_up
from akaze_tpu_torch.kernels.describe import describe as describe_fused
from akaze_tpu_torch.kernels.describe import describe_from_samples, describe_plain, kernel_table, zero_invalid
from akaze_tpu_torch.kernels.describe_single import describe_pallas, describe_pallas_plain
from akaze_tpu_torch.kernels.patch import gather_patches, gather_patches_plain

# Slots gathered and described together (at 64 x 64 patches, 1.6 GB of
# patches per group).
_GROUP_SLOTS = 32768


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DescribeTables:
    """The sampling patterns of a `DescribeStatics` on one device."""

    ori_di: torch.Tensor  # (109,) float32 orientation offsets, x
    ori_dj: torch.Tensor  # (109,) float32 orientation offsets, y
    ori_w: torch.Tensor  # (109,) float32 orientation weights
    win_lo: torch.Tensor  # (42,) float32 window bounds
    win_hi: torch.Tensor
    win_wrap: torch.Tensor  # (42,) bool
    all_offk: torch.Tensor  # (S,) float32 M-LDB offsets
    all_offl: torch.Tensor
    grids: tuple  # per grid: DescribeStatics.grids' arrays, indices as int64
    table: torch.Tensor  # kernels 3 and 6's int32 table (`kernel_table`)
    table_sizes: tuple  # its sizes, host ints


class DescribeStatics:
    """Sampling patterns shared by orientation and M-LDB (numpy), and their
    device copies (`on`)."""

    def __init__(self, config: AkazeConfig, ss_statics: ScaleSpaceStatics):
        self.config = config
        # Orientation circle: |(i, j)| < 6, Gaussian sigma_w = 2.5.
        offs = [(i, j) for i in range(-6, 7) for j in range(-6, 7) if i * i + j * j < 36]
        self.ori_di = np.array([o[0] for o in offs], np.float32)  # x
        self.ori_dj = np.array([o[1] for o in offs], np.float32)  # y
        self.ori_w = np.exp(
            -(self.ori_di**2 + self.ori_dj**2) / (2.0 * 2.5 * 2.5)
        ).astype(np.float32)
        # Sliding pi/3 windows starting every 0.15 rad.
        ang1 = np.arange(0.0, 2.0 * math.pi, 0.15)
        self.win_lo = ang1.astype(np.float32)
        self.win_hi = (ang1 + math.pi / 3.0).astype(np.float32)
        self.win_wrap = self.win_hi > 2.0 * math.pi

        # M-LDB grids sample overlapping integer offsets (441 unique of 1241
        # for p = 10): sampling runs once over the unique offsets, and each
        # grid's cell means are a (unique, cells) mean matrix over them.
        # Kernels 3 and 6 sum each cell's members instead: (cells, m) sample
        # indices in increasing order (the cells of a grid are equal
        # squares) and (cells,) mean weights.
        p = config.descriptor_pattern_size
        unique: dict[tuple, int] = {}
        self.grids = []
        raw_grids = []
        for step in (p, int(math.ceil(2.0 * p / 3.0)), p // 2):
            entries = []  # (unique_idx, cell_idx)
            ci = 0
            for i in range(-p, p, step):
                for j in range(-p, p, step):
                    for k in range(i, i + step):
                        for l in range(j, j + step):
                            u = unique.setdefault((k, l), len(unique))
                            entries.append((u, ci))
                    ci += 1
            raw_grids.append((entries, ci))
        n_unique = len(unique)
        for entries, n_cells in raw_grids:
            mean_mat = np.zeros((n_unique, n_cells), np.float32)
            for u, c in entries:
                mean_mat[u, c] += 1.0
            mean_mat /= mean_mat.sum(axis=0, keepdims=True)
            pa, pb = np.triu_indices(n_cells, k=1)  # a-major pair order
            members = np.stack([np.nonzero(mean_mat[:, c])[0] for c in range(n_cells)])
            self.grids.append(dict(mean_mat=mean_mat, pa=pa.astype(np.int32), pb=pb.astype(np.int32),
                                   members=members, weights=mean_mat[members[:, 0], np.arange(n_cells)]))
        self.total_bits = config.descriptor_bits
        offs = np.array(sorted(unique, key=unique.get), np.float32)
        self.all_offk = offs[:, 0]
        self.all_offl = offs[:, 1]
        self.n_samples = n_unique

        # Patch geometry of the non-fused describe: the worst-case reach of
        # any sample (the M-LDB pattern or the orientation circle, plus
        # rounding slack) sizes one (ph, pw) window per keypoint.
        s_max = int(ss_statics.scale.max())
        reach = int(math.ceil(p * s_max * math.sqrt(2.0))) + 2
        self.reach = max(reach, 6 * s_max + 2)
        self.ph = min(_round_up(2 * self.reach, 8), ss_statics.h0)
        self.pw = min(_round_up(2 * self.reach, 64), ss_statics.w0)
        self.chunk = 256  # keypoint slots per chunk; chunks with no valid slot are skipped
        self._on = {}

    def on(self, device) -> DescribeTables:
        """The sampling patterns on `device`: copied there on the first call
        for that device, then kept as long as the statics."""
        device = torch.device(device)
        tables = self._on.get(device)
        if tables is None:
            up = lambda a: torch.as_tensor(a, device=device)
            # Index arrays as int64, as torch indexes with them.
            grids = tuple({k: up(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in g.items()}
                          for g in self.grids)
            tab, sizes = kernel_table(self)
            tables = self._on[device] = DescribeTables(
                ori_di=up(self.ori_di), ori_dj=up(self.ori_dj), ori_w=up(self.ori_w), win_lo=up(self.win_lo),
                win_hi=up(self.win_hi), win_wrap=up(self.win_wrap), all_offk=up(self.all_offk),
                all_offl=up(self.all_offl), grids=grids, table=up(tab), table_sizes=sizes)
        return tables


def chunk_geometry(x, y, class_id, ss: ScaleSpaceStatics, ds: DescribeStatics) -> dict:
    """Per-slot level geometry and patch origins of flat (N,) keypoint
    fields: every clipped sample coordinate lands inside the (ph, pw)
    window at (y0, x0)."""
    t = ss.on(x.device)
    lvl = class_id.long()
    ratios = t.ratios[lvl]
    widths, heights = t.widths[lvl], t.heights[lvl]
    xf, yf = x / ratios, y / ratios
    zero = torch.zeros_like(widths)
    y0 = torch.clamp(round_half_up(yf) - ds.ph // 2, min=zero, max=torch.clamp(heights - ds.ph, min=0))
    x0 = torch.clamp(round_half_up(xf) - ds.pw // 2, min=zero, max=torch.clamp(widths - ds.pw, min=0))
    return {"lvl": lvl, "scale": t.scale[lvl].to(torch.float32), "w": widths,
            "h": heights, "xf": xf, "yf": yf, "y0": y0, "x0": x0}


def _describe_chunk(geo: dict, patches: torch.Tensor, ds: DescribeStatics):
    """Orientation + descriptor of N slots from their (N, 3, ph, pw)
    windows: samples by patch-local index (the value the JAX package's
    one-hot matmuls select, zero outside the window), the library atan2.
    Returns (angles (N,), words (N, W) int32)."""
    n, _, ph, pw = patches.shape
    flat = patches.reshape(-1)
    base = (torch.arange(n, device=patches.device) * 3)[:, None]
    xf, yf, sc = geo["xf"][:, None], geo["yf"][:, None], geo["scale"][:, None]
    ymax, xmax = (geo["h"] - 1)[:, None], (geo["w"] - 1)[:, None]

    def sample(channels, offx, offy):
        iy = torch.clamp(round_half_up(yf + offy * sc), min=torch.zeros_like(ymax), max=ymax) - geo["y0"][:, None]
        ix = torch.clamp(round_half_up(xf + offx * sc), min=torch.zeros_like(xmax), max=xmax) - geo["x0"][:, None]
        inside = (iy >= 0) & (iy < ph) & (ix >= 0) & (ix < pw)
        pix = torch.clamp(iy, 0, ph - 1).long() * pw + torch.clamp(ix, 0, pw - 1).long()
        zero = torch.zeros((), device=patches.device)
        return [torch.where(inside, flat[(base + c) * (ph * pw) + pix], zero) for c in channels]

    return describe_from_samples(sample, ds, patches.device, xla=True)


def chunk_slots(kps: Keypoints, ds: DescribeStatics):
    """(B, M) keypoint slots cut into chunks of `ds.chunk` per frame (the
    last one padded with invalid slots): (B * nc, C) fields "x", "y",
    "class_id", "valid", "frame", and the indices of the live chunks, those
    with a valid slot (this reads the validity back to the host)."""
    B, M = kps.x.shape
    C = min(ds.chunk, M)
    nc = (M + C - 1) // C
    pad = nc * C - M
    cut = lambda a, fill: torch.nn.functional.pad(a, (0, pad), value=fill).reshape(B * nc, C)
    fields = {"x": cut(kps.x, 0.0), "y": cut(kps.y, 0.0), "class_id": cut(kps.class_id, 0),
              "valid": cut(kps.valid, False)}
    fields["frame"] = torch.arange(B, device=kps.x.device).repeat_interleave(nc)[:, None].expand(B * nc, C)
    return fields, torch.nonzero(fields["valid"].any(dim=1)).flatten()


def _describe_slots(kps: Keypoints, stacks: dict, ss: ScaleSpaceStatics, ds: DescribeStatics,
                    plain: bool):
    """The non-fused describe of (B, M) keypoint slots over Lt/Lx/Ly stacks
    in any layout kernel 7 takes: dead chunks skipped, live ones gathered
    and described in groups.  Returns (angles (B, M), words (B, M, W))
    with invalid slots zero."""
    B, M = kps.x.shape
    fields, live = chunk_slots(kps, ds)
    C = fields["x"].shape[1]
    nwords = ds.config.descriptor_words
    angles = torch.zeros(fields["x"].shape, dtype=torch.float32, device=kps.x.device)
    words = torch.zeros(angles.shape + (nwords,), dtype=torch.int32, device=kps.x.device)
    gather = gather_patches_plain if plain else gather_patches
    group = max(1, _GROUP_SLOTS // C)
    for g0 in range(0, live.numel(), group):
        sel = live[g0 : g0 + group]
        f = {k: v[sel].reshape(-1) for k, v in fields.items()}
        geo = chunk_geometry(f["x"], f["y"], f["class_id"], ss, ds)
        patches = gather(stacks, f["frame"], geo["lvl"], geo["y0"], geo["x0"], f["valid"], ds.ph, ds.pw)
        a, w = _describe_chunk(geo, patches, ds)
        angles[sel] = a.reshape(-1, C)
        words[sel] = w.reshape(-1, C, nwords)
    angles = angles.reshape(B, -1)[:, :M]
    words = words.reshape(B, -1, nwords)[:, :M]
    return zero_invalid(angles, words, kps.valid)


def _describe_backend(config: AkazeConfig) -> str:
    """"fused" (kernel 3; "auto" picks it, as on a TPU), "xla" or "pallas"
    (both the non-fused branch in the batched describe)."""
    b = config.describe_backend
    if b == "auto":
        return "fused"
    if b in ("fused", "xla", "pallas"):
        return b
    raise ValueError(f"describe_backend must be auto, fused, xla or pallas, got {b!r}")


def restack_levels(lvl_oct, ss: ScaleSpaceStatics) -> dict:
    """Per-octave level-major (n, B, h, w) Lt/Lx/Ly planes -> padded
    level-major (L, B, H0, W0) stacks, zeros outside each level (three
    views of one (3, L, B, H0, W0) tensor)."""
    B = lvl_oct[0]["Lt"].shape[1]
    s3 = lvl_oct[0]["Lt"].new_zeros((3, ss.num_levels, B, ss.h0, ss.w0))
    for (l0, n, h, w), o in zip(ss.groups, lvl_oct):
        for c, key in enumerate(("Lt", "Lx", "Ly")):
            s3[c, l0 : l0 + n, :, :h, :w] = o[key]
    return {"Lt": s3[0], "Lx": s3[1], "Ly": s3[2], "level_major": True}


def describe_batched(kps: Keypoints, lvl_oct, ss: ScaleSpaceStatics, ds: DescribeStatics,
                     plain: bool = False) -> Features:
    """Description of (B, M) keypoints on the per-octave planes of the
    batched build, on the branch `config.describe_backend` picks.
    plain=True runs the plain twins on any device (for comparisons)."""
    M = kps.x.shape[1]
    if _describe_backend(ds.config) == "fused" and M % 64 == 0:
        angles, descs = (describe_plain if plain else describe_fused)(kps, lvl_oct, ss, ds)
    else:
        angles, descs = _describe_slots(kps, restack_levels(lvl_oct, ss), ss, ds, plain)
    return Features(dataclasses.replace(kps, angle=angles), descs)


def describe(kps: Keypoints, stacks: dict, ss: ScaleSpaceStatics, ds: DescribeStatics,
             backend: str = "xla", plain: bool = False) -> Features:
    """Description of one frame's (M,) keypoints on its padded (L, H0, W0)
    Lt/Lx/Ly stacks: backend "xla" is the non-fused branch (kernel 7
    windows), "pallas" kernel 6.  plain=True runs the plain twins on any
    device (for comparisons)."""
    if backend == "pallas":
        angles, descs = (describe_pallas_plain if plain else describe_pallas)(kps, stacks, ss, ds)
    elif backend == "xla":
        fields = dataclasses.replace(kps, **{f.name: getattr(kps, f.name)[None]
                                             for f in dataclasses.fields(kps)})
        angles, descs = (a[0] for a in _describe_slots(fields, stacks, ss, ds, plain))
    else:
        raise ValueError(f"describe backend must be xla or pallas, got {backend!r}")
    return Features(dataclasses.replace(kps, angle=angles), descs)
