"""Kernel 4 (`match_reduce`): per-row best / second / nearest and
per-column minimum / argmin of the Hamming distances between descriptor
sets, over a batch of pairs, with its plain PyTorch twin (counterpart of
the JAX package's `akaze_tpu/kernels/match_pallas.py`).

The CUDA kernel (`csrc/match.cu`) computes the distances on the tensor
cores as |a| + |b| - 2 |a & b| over (ROW_TILE x COL_TILE) tiles, each
block owning ROW_TILE rows of A and walking the column tiles of B in
order, four warps of (WARP_ROWS x WARP_COLS) per tile;
`tests/test_torch_match_tiles.py` replays that decomposition on the CPU.

Descriptors are (P, K, 16) int32 bit patterns; validity masks are (P, K)
bool.  Rows see only B-valid columns, columns only A-valid rows, and the
lowest index wins every tie.  A row with no valid column gets best =
second = 1 << 30 and nn = 0; a column with no valid row gets colmin =
1 << 30 and colarg = 0.
"""

from __future__ import annotations

import ctypes

import torch

from akaze_tpu_torch.kernels import _build

BIG = 1 << 30
#: The kernel's tiling (the #defines TR, TC and its warp tiles in csrc/match.cu).
ROW_TILE, COL_TILE = 64, 128
WARP_ROWS, WARP_COLS = 32, 64
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming_distance_matrix(a: torch.Tensor, b: torch.Tensor, rows: int = 128) -> torch.Tensor:
    """a (Ka, W), b (Kb, W) int32 -> (Ka, Kb) int32 popcount(a ^ b).

    The popcount reads a 256-entry byte table through a uint8 view (torch
    on the CPU does not shift uint32); rows go in chunks to bound memory."""
    lut = _POPCOUNT.to(a.device)
    out = [torch.zeros((0, b.shape[0]), dtype=torch.int32, device=a.device)]
    for r0 in range(0, a.shape[0], rows):
        x = (a[r0 : r0 + rows, None, :] ^ b[None, :, :]).contiguous()
        out.append(lut[x.view(torch.uint8).long()].sum(-1, dtype=torch.int32))
    return torch.cat(out)


def match_reduce_plain(da, va, db, vb):
    """Plain twin of kernel 4: five int32 tensors (best, second, nn) (P, Ka)
    and (colmin, colarg) (P, Kb)."""
    outs = []
    for p in range(da.shape[0]):
        d = hamming_distance_matrix(da[p], db[p])
        big = torch.full_like(d, BIG)
        dbm = torch.where(vb[p][None, :], d, big)
        nn = torch.argmin(dbm, dim=1)  # first minimum
        best = dbm.gather(1, nn[:, None])[:, 0]
        cols = torch.arange(d.shape[1], device=d.device)
        second = torch.where(cols[None, :] == nn[:, None], big, dbm).amin(dim=1)
        dam = torch.where(va[p][:, None], d, big)
        colarg = torch.argmin(dam, dim=0)
        colmin = dam.gather(0, colarg[None, :])[0]
        outs.append((best, second, nn.to(torch.int32), colmin, colarg.to(torch.int32)))
    if not outs:
        ka, kb = da.shape[1], db.shape[1]
        z = lambda k: torch.zeros((0, k), dtype=torch.int32, device=da.device)
        return z(ka), z(ka), z(ka), z(kb), z(kb)
    return tuple(torch.stack(x) for x in zip(*outs))


def _check(da, va, db, vb) -> None:
    for name, d, v in (("A", da, va), ("B", db, vb)):
        if d.dtype != torch.int32 or d.ndim != 3 or d.shape[2] != 16 or not d.is_contiguous():
            raise ValueError(f"match_reduce: descriptors {name} must be contiguous int32 (P, K, 16)")
        if v.dtype != torch.bool or v.shape != d.shape[:2] or not v.is_contiguous():
            raise ValueError(f"match_reduce: validity {name} must be contiguous bool (P, K)")
        if d.device != da.device or v.device != da.device:
            raise ValueError("match_reduce: all tensors must be on one device")
    if da.shape[0] != db.shape[0]:
        raise ValueError("match_reduce: A and B hold different numbers of pairs")
    if da.shape[1] > 65536 or da.shape[0] > 65535:
        raise ValueError("match_reduce: the kernel takes at most 65536 rows and 65535 pairs")
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("match_reduce: descriptors must start on a 16-byte boundary")


def match_reduce(da, va, db, vb):
    """Kernel 4 on CUDA tensors (one launch over all pairs), its plain twin
    on CPU tensors."""
    if da.device.type == "cpu":
        return match_reduce_plain(da, va, db, vb)
    _build.require_cuda(da, "match_reduce")
    _check(da, va, db, vb)
    P, Ka, _ = da.shape
    Kb = db.shape[1]
    new = lambda k: torch.empty((P, k), dtype=torch.int32, device=da.device)
    best, second, nn, colmin, colarg, colkey = new(Ka), new(Ka), new(Ka), new(Kb), new(Kb), new(Kb)
    P_, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("match", "match_reduce", [P_, P_, P_, P_, I, I, I, P_, P_, P_, P_, P_, P_, P_])
    with torch.cuda.device(da.device):
        err = fn(da.data_ptr(), va.data_ptr(), db.data_ptr(), vb.data_ptr(), P, Ka, Kb,
                 best.data_ptr(), second.data_ptr(), nn.data_ptr(), colmin.data_ptr(),
                 colarg.data_ptr(), colkey.data_ptr(), _build.stream_of(da))
    _build.check("match", err, "match_reduce")
    _build.launches["match"] += 1
    return best, second, nn, colmin, colarg
