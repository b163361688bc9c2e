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

With a pair table (`pairs`, a contiguous (P, 2) int32 tensor on the
descriptors' device) the sides are sets of views, (NA, Ka, 16) / (NA, Ka)
and (NB, Kb, 16) / (NB, Kb), and pair p matches A view pairs[p, 0] against
B view pairs[p, 1]; the outputs are (P, Ka) and (P, Kb) as before, from one
launch that reads both sides through the table.  `pair_table` checks a
table's range on the host and keeps its device copy per content and
device; the wrapper takes a table on the card only from it, so a range is
never checked by a read from the device.
"""

from __future__ import annotations

import collections
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


def match_reduce_plain(da, va, db, vb, pairs=None):
    """Plain twin of kernel 4: five int32 tensors (best, second, nn) (P, Ka)
    and (colmin, colarg) (P, Kb); with `pairs`, pair p reads A view
    pairs[p, 0] and B view pairs[p, 1]."""
    n = da.shape[0] if pairs is None else pairs.shape[0]
    index = [(p, p) for p in range(n)] if pairs is None else pairs.cpu().tolist()
    outs = []
    for ia, ib in index:
        d = hamming_distance_matrix(da[ia], db[ib])
        big = torch.full_like(d, BIG)
        dbm = torch.where(vb[ib][None, :], d, big)
        nn = torch.argmin(dbm, dim=1)  # first minimum
        best = dbm.gather(1, nn[:, None])[:, 0]
        cols = torch.arange(d.shape[1], device=d.device)
        second = torch.where(cols[None, :] == nn[:, None], big, dbm).amin(dim=1)
        dam = torch.where(va[ia][:, None], d, big)
        colarg = torch.argmin(dam, dim=0)
        colmin = dam.gather(0, colarg[None, :])[0]
        outs.append((best, second, nn.to(torch.int32), colmin, colarg.to(torch.int32)))
    if not outs:
        ka, kb = da.shape[1], db.shape[1]
        z = lambda k: torch.zeros((0, k), dtype=torch.int32, device=da.device)
        return z(ka), z(ka), z(ka), z(kb), z(kb)
    return tuple(torch.stack(x) for x in zip(*outs))


#: Device copies of pair tables, most recent last: {(content, device):
#: (table, (least, largest) A view, (least, largest) B view)}.
_tables: collections.OrderedDict = collections.OrderedDict()
_TABLES_KEPT = 8


def _spans(table: torch.Tensor):
    """The (least, largest) A and B view of a host (P, 2) table."""
    if table.shape[0] == 0:
        return (0, -1), (0, -1)
    lo, hi = table.amin(0).tolist(), table.amax(0).tolist()
    return (lo[0], hi[0]), (lo[1], hi[1])


def _check_table(pairs, na: int, nb: int, device: torch.device) -> None:
    """Refuses a pair table that is not a contiguous int32 (P, 2) tensor on
    `device` with A views in [0, na) and B views in [0, nb).  A table on
    the host is read where it is; one on the card must be `pair_table`'s,
    whose range was read on the host."""
    if not isinstance(pairs, torch.Tensor) or pairs.dtype != torch.int32 or pairs.ndim != 2 \
            or pairs.shape[1] != 2 or not pairs.is_contiguous():
        what = f"{pairs.dtype} {tuple(pairs.shape)}" if isinstance(pairs, torch.Tensor) else type(pairs).__name__
        raise ValueError(f"match_reduce: the pair table must be a contiguous int32 (P, 2) tensor, got {what}")
    if pairs.device != device:
        raise ValueError(f"match_reduce: the pair table is on {pairs.device}, the descriptors on {device}")
    if pairs.shape[0] > 65535:
        raise ValueError("match_reduce: the kernel takes at most 65535 pairs")
    if pairs.device.type == "cpu":
        span_a, span_b = _spans(pairs)
    else:
        found = [v for v in _tables.values() if v[0] is pairs]
        if not found:
            raise ValueError("match_reduce: a pair table on the card must come from pair_table, "
                             "which checks its range on the host")
        _, span_a, span_b = found[0]
    for side, (lo, hi), n in (("A", span_a, na), ("B", span_b, nb)):
        if lo <= hi and (lo < 0 or hi >= n):
            raise ValueError(f"match_reduce: the pair table names {side} views {lo}..{hi}, the set holds {n}")


def pair_table(pairs, na: int, nb: int, device) -> torch.Tensor:
    """A (P, 2) int32 pair table (a CPU tensor, or a table this function
    returned) checked on the host against sets of na A views and nb B
    views, on `device`: a table on the host is used where it is; the device
    copy is made once per content and device (the last few are kept), so a
    call with a known table uploads nothing."""
    device = torch.device(device)
    if isinstance(pairs, torch.Tensor) and pairs.device.type != "cpu":
        _check_table(pairs, na, nb, device)  # a table of this cache, or refused
        return pairs
    _check_table(pairs, na, nb, torch.device("cpu"))
    if device.type == "cpu":
        return pairs
    key = (pairs.numpy().tobytes(), device)
    entry = _tables.get(key)
    if entry is None:
        entry = (pairs.to(device), *_spans(pairs))
        _tables[key] = entry
        while len(_tables) > _TABLES_KEPT:
            _tables.popitem(last=False)
    _tables.move_to_end(key)
    return entry[0]


def _check(da, va, db, vb, pairs=None) -> None:
    for name, d, v in (("A", da, va), ("B", db, vb)):
        if d.dtype != torch.int32 or d.ndim != 3 or d.shape[2] != 16 or not d.is_contiguous():
            raise ValueError(f"match_reduce: descriptors {name} must be contiguous int32 (P, K, 16)")
        if v.dtype != torch.bool or v.shape != d.shape[:2] or not v.is_contiguous():
            raise ValueError(f"match_reduce: validity {name} must be contiguous bool (P, K)")
        if d.device != da.device or v.device != da.device:
            raise ValueError("match_reduce: all tensors must be on one device")
    if pairs is None and da.shape[0] != db.shape[0]:
        raise ValueError("match_reduce: A and B hold different numbers of pairs")
    if pairs is not None:
        _check_table(pairs, da.shape[0], db.shape[0], da.device)
    if da.shape[1] > 65536 or (pairs is None and da.shape[0] > 65535):
        raise ValueError("match_reduce: the kernel takes at most 65536 rows and 65535 pairs")
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("match_reduce: descriptors must start on a 16-byte boundary")


def match_reduce(da, va, db, vb, pairs=None):
    """Kernel 4 on CUDA tensors (one launch over all pairs), its plain twin
    on CPU tensors; `pairs` as in the module's docstring."""
    if da.device.type == "cpu":
        if pairs is not None:
            _check_table(pairs, da.shape[0], db.shape[0], da.device)
        return match_reduce_plain(da, va, db, vb, pairs)
    _build.require_cuda(da, "match_reduce")
    _check(da, va, db, vb, pairs)
    P = da.shape[0] if pairs is None else pairs.shape[0]
    Ka, Kb = da.shape[1], db.shape[1]
    new = lambda k: torch.empty((P, k), dtype=torch.int32, device=da.device)
    best, second, nn, colmin, colarg, colkey = new(Ka), new(Ka), new(Ka), new(Kb), new(Kb), new(Kb)
    ia = ib = None
    if pairs is not None:
        ia, ib = pairs.data_ptr(), pairs.data_ptr() + pairs.element_size()  # the table's two columns
    P_, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("match", "match_reduce", [P_, P_, P_, P_, P_, P_, I, I, I, P_, P_, P_, P_, P_, P_, P_])
    with torch.cuda.device(da.device):
        err = fn(da.data_ptr(), va.data_ptr(), db.data_ptr(), vb.data_ptr(), ia, ib, P, Ka, Kb,
                 best.data_ptr(), second.data_ptr(), nn.data_ptr(), colmin.data_ptr(),
                 colarg.data_ptr(), colkey.data_ptr(), _build.stream_of(da))
    _build.check("match", err, "match_reduce")
    _build.launches["match"] += 1
    _build.counts["match_pairs"] += P
    _build.counts["match_slot_pairs"] += P * Ka * Kb
    return best, second, nn, colmin, colarg
