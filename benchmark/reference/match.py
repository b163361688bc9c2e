"""The plain reference of the brute-force Hamming matcher: nearest and
second-nearest neighbour of every row of A among the valid rows of B
(lowest index on ties), then the max-distance, ratio and mutual filters in
float32, as the upstream matcher states them."""

from __future__ import annotations

import torch

BIG = 1 << 30
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor, rows: int = 128) -> torch.Tensor:
    """a (Ka, W), b (Kb, W) int32 words -> (Ka, Kb) int32 popcount(a ^ b)."""
    lut = _POPCOUNT.to(a.device)
    out = [torch.zeros((0, b.shape[0]), dtype=torch.int32, device=a.device)]
    for r0 in range(0, a.shape[0], rows):
        x = (a[r0 : r0 + rows, None, :] ^ b[None, :, :]).contiguous()
        out.append(lut[x.view(torch.uint8).long()].sum(-1, dtype=torch.int32))
    return torch.cat(out)


def match(da, va, db, vb, ratio: float = 0.8, mutual: bool = True, max_distance: int = 486) -> dict:
    """(P, K, W) descriptors and (P, K) masks of pairs -> {"idx_b",
    "distance", "accepted"}, each (P, Ka)."""
    idx_b, dist, acc = [], [], []
    for p in range(da.shape[0]):
        d = hamming(da[p], db[p])
        big = torch.full_like(d, BIG)
        dbm = torch.where(vb[p][None, :], d, big)
        nn = torch.argmin(dbm, dim=1)
        best = dbm.gather(1, nn[:, None])[:, 0]
        cols = torch.arange(d.shape[1], device=d.device)
        second = torch.where(cols[None, :] == nn[:, None], big, dbm).amin(dim=1)
        colarg = torch.argmin(torch.where(va[p][:, None], d, big), dim=0)
        ok = va[p] & (best <= max_distance)
        ok &= best.to(torch.float32) < ratio * second.to(torch.float32)
        if mutual:
            ok &= colarg[nn] == torch.arange(d.shape[0], device=d.device)
        idx_b.append(nn.to(torch.int32))
        dist.append(best)
        acc.append(ok)
    return {"idx_b": torch.stack(idx_b), "distance": torch.stack(dist), "accepted": torch.stack(acc)}
