"""The plain reference of matching a set of views over a pair list: the
reference matcher (`reference/match.py`) run on each listed pair in turn."""

from __future__ import annotations

import torch

from benchmark.reference import match as ref_match


def exhaustive(views: int) -> list:
    """Every pair (i, j) of `views` views with i < j, in row-major order."""
    return [(i, j) for i in range(views) for j in range(i + 1, views)]


def match(da, va, db, vb, pairs, ratio: float = 0.8, mutual: bool = True, max_distance: int = 486) -> dict:
    """(NA, Ka, W) / (NA, Ka) and (NB, Kb, W) / (NB, Kb) sets and a list of
    (A view, B view) pairs -> {"idx_b", "distance", "accepted"}, each
    (len(pairs), Ka), row p from matching the pair pairs[p]."""
    out = {"idx_b": [], "distance": [], "accepted": []}
    for i, j in pairs:
        m = ref_match.match(da[i : i + 1], va[i : i + 1], db[j : j + 1], vb[j : j + 1],
                            ratio=ratio, mutual=mutual, max_distance=max_distance)
        for key in out:
            out[key].append(m[key])
    if not pairs:
        dev, ka = da.device, da.shape[1]
        return {"idx_b": torch.zeros((0, ka), dtype=torch.int32, device=dev),
                "distance": torch.zeros((0, ka), dtype=torch.int32, device=dev),
                "accepted": torch.zeros((0, ka), dtype=torch.bool, device=dev)}
    return {key: torch.cat(parts) for key, parts in out.items()}
