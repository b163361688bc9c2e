"""Kernel 4's decomposition (`csrc/match.cu`) replayed on the CPU.

The CUDA kernel cannot run here, so `_replay` does what its blocks do, in
plain PyTorch: Hamming distances as |a| + |b| - 2 |a & b| from an integer
matrix product on descriptors unpacked to 0/1 bits; (ROW_TILE x COL_TILE)
tiles, a block per row tile walking the column tiles in order and skipping
those no output depends on; per thread a (best, nn, second) state over its
columns of each warp block in increasing order, merged across the quad and
then the two warp columns by `_merge`; column keys (d << 16) | row reduced
by min.  It must equal JAX's `match_reduce` (Pallas, interpret mode) and
`match_reduce_plain` exactly, ties included.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu.kernels.match_pallas import match_reduce as jax_match_reduce
from akaze_tpu_torch.kernels.match import (
    BIG, COL_TILE, ROW_TILE, WARP_COLS, WARP_ROWS, match_reduce_plain,
)
from torch_port_helpers import MATCH_CASES, match_case

torch.set_num_threads(2)
NO_KEY = 0xFFFFFFFF
QUAD = 4  # threads of an mma fragment that share its rows (each takes 2 of every 8 columns)


def _bits(d: torch.Tensor) -> torch.Tensor:
    """(K, 16) int32 -> (K, 512) int64 0/1; A and B are unpacked alike, so
    the bit order does not matter."""
    u8 = d.contiguous().view(torch.uint8)
    return ((u8[..., None] >> torch.arange(8, dtype=torch.uint8)) & 1).reshape(d.shape[0], -1).long()


def _merge(x, y):
    """Row states (best, nn, second): the smaller (distance, column) wins;
    second = min(winner's second, loser's best)."""
    bx, ax, sx = x
    by, ay, sy = y
    take = (by < bx) | ((by == bx) & (ay < ax))
    second = torch.minimum(torch.where(take, sy, sx), torch.where(take, bx, by))
    return torch.where(take, by, bx), torch.where(take, ay, ax), second


def _replay(da, va, db, vb):
    """One pair through kernel 4's tiles: (Ka, 16), (Ka,), (Kb, 16), (Kb,) ->
    best, second, nn (Ka,) and colmin, colarg (Kb,)."""
    Ka, Kb = da.shape[0], db.shape[0]
    A, B = _bits(da), _bits(db)
    pa, pb = A.sum(1), B.sum(1)
    out_b, out_s, out_n = (torch.zeros(Ka, dtype=torch.long) for _ in range(3))
    colkey = torch.full((Kb,), NO_KEY, dtype=torch.long)
    wcs, nts = COL_TILE // WARP_COLS, WARP_COLS // 8  # warp columns, n-tiles of a warp block
    for r0 in range(0, Ka, ROW_TILE):
        rows = torch.arange(r0, min(Ka, r0 + ROW_TILE))
        nr, rowany = len(rows), bool(va[rows].any())
        # One state per (row, warp column, thread of the quad).
        shape = (nr, wcs, QUAD)
        state = (torch.full(shape, BIG), torch.zeros(shape, dtype=torch.long), torch.full(shape, BIG))
        for c0 in range(0, Kb, COL_TILE):
            cols = torch.arange(c0, min(Kb, c0 + COL_TILE))
            colany = bool(vb[cols].any())
            if not rowany and not colany:
                continue  # the tile skip
            d = pa[rows, None] + pb[None, cols] - 2 * (A[rows] @ B[cols].T)
            pad = COL_TILE - len(cols)
            # Tile column 64 wc + 8 ni + 2 t + j -> (wc, ni, t, j).
            dt = torch.nn.functional.pad(d, (0, pad)).reshape(nr, wcs, nts, QUAD, 2)
            ok = torch.nn.functional.pad(vb[cols], (0, pad)).reshape(wcs, nts, QUAD, 2)
            ct = (c0 + torch.arange(COL_TILE)).reshape(wcs, nts, QUAD, 2)
            if colany:
                b, a, s = state
                for ni in range(nts):
                    for j in range(2):
                        dd, v, c = dt[:, :, ni, :, j], ok[None, :, ni, :, j], ct[None, :, ni, :, j]
                        better = v & (dd < b)
                        s = torch.where(better, b, torch.where(v & (dd < s), dd, s))
                        b = torch.where(better, dd, b)
                        a = torch.where(better, c.expand_as(a), a)
                state = (b, a, s)
            if rowany:
                keys = torch.where(va[rows][:, None], (d << 16) | rows[:, None], NO_KEY)
                keys = torch.nn.functional.pad(keys, (0, 0, 0, ROW_TILE - nr), value=NO_KEY)
                # Rows 32 wr + 16 mi + 8 h + g: a thread's four rows, then the
                # 8 lanes of a column (xor 4, 8, 16), then atomicMin.
                keys = keys.reshape(ROW_TILE // WARP_ROWS, 2, 2, 8, len(cols)).amin(dim=(1, 2)).amin(dim=1)
                colkey[cols] = torch.minimum(colkey[cols], keys.amin(dim=0))
        # Across the quad (xor 1, then xor 2), then warp column 0 with 1.
        part = lambda k, q: tuple(x[:, k, q] for x in state)
        for wc in range(wcs):
            q01, q23 = _merge(part(wc, 0), part(wc, 1)), _merge(part(wc, 2), part(wc, 3))
            merged = _merge(q01, q23)
            acc = merged if wc == 0 else _merge(acc, merged)
        out_b[rows], out_n[rows], out_s[rows] = acc
    found = colkey != NO_KEY
    colmin = torch.where(found, colkey >> 16, BIG)
    colarg = torch.where(found, colkey & 0xFFFF, 0)
    return tuple(x.to(torch.int32) for x in (out_b, out_s, out_n, colmin, colarg))


@pytest.mark.parametrize("ka,kb,mask", MATCH_CASES)
def test_tile_replay_equals_jax_and_plain(ka, kb, mask):
    a, va, b, vb = match_case(ka, kb, mask)
    t = lambda x: torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
    got = _replay(t(a), t(va), t(b), t(vb))
    want = jax_match_reduce(a, va, b, vb, interpret=True)
    plain = match_reduce_plain(t(a)[None], t(va)[None], t(b)[None], t(vb)[None])
    for name, g, w, p in zip(("best", "second", "nn", "colmin", "colarg"), got, want, plain):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), p[0].numpy(), err_msg=name)
    if mask == "invalid_b":
        assert (got[0] == BIG).all() and (got[2] == 0).all()


def test_tiling_follows_the_kernel_source():
    """The replay's tile and warp-block shapes are the kernel's."""
    src = (Path(__file__).resolve().parents[1] / "akaze_tpu_torch" / "csrc" / "match.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\d+)", src, flags=re.M))
    assert (int(defines["TR"]), int(defines["TC"])) == (ROW_TILE, COL_TILE)
    assert (int(defines["WARP_ROWS"]), int(defines["WARP_COLS"])) == (WARP_ROWS, WARP_COLS)
