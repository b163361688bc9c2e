"""Orientation + M-LDB description statics and stage (counterpart of the
JAX package's `akaze_tpu/frontend/describe.py`).

Orientation: SURF-style dominant direction from Gaussian-weighted Lx/Ly
samples on a discrete circle (109 offsets) and 42 sliding pi/3 windows.
M-LDB: per-cell means of (Lt, rotated Lx, rotated Ly) over 2x2/3x3/4x4
grids of a rotated pattern (441 unique offsets), compared pairwise into 486
bits, packed LSB-first into 16 words.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5).to(torch.int32)


def _per_level_scale(ss_statics: ScaleSpaceStatics) -> np.ndarray:
    """Reference `scale = max(1, round(0.5 * size / ratio))` per level."""
    s = np.floor(0.5 * ss_statics.sizes / ss_statics.ratios + 0.5).astype(np.int32)
    return np.maximum(s, 1)


class DescribeStatics:
    """Sampling patterns shared by orientation and M-LDB (numpy)."""

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
            self.grids.append(dict(mean_mat=mean_mat, pa=pa.astype(np.int32), pb=pb.astype(np.int32)))
        self.total_bits = config.descriptor_bits
        offs = np.array(sorted(unique, key=unique.get), np.float32)
        self.all_offk = offs[:, 0]
        self.all_offl = offs[:, 1]
        self.n_samples = n_unique

