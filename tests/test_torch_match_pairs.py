"""Kernel 4 over a pair table (`kernels/match.py` `pair_table`,
`match_reduce(..., pairs)`, `matching/hamming.py` `match_fn(..., pairs)`):
a set of views matched over a list of pairs in one launch.

On the CPU the plain twin over a table equals the benchmark's reference
matcher run pair by pair (all pairs of 5 views, repeated pairs, a view
against itself, a view with no valid slot, two sets of different sizes,
no pair at all), and every malformed table is refused.  On the card
(`gpu`-marked, skipping without one) the kernel over a table is bit-equal
to the kernel over the gathered (P, K, 16) copies, at K = 1,024 and at
K = 8,192 with all 435 pairs of 30 views, in one launch per call.  The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_match_pairs.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import MatchConfig
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain, pair_table
from akaze_tpu_torch.matching.hamming import match, match_fn
from torch_port_helpers import cuda  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import match as ref_match  # noqa: E402

OUTPUTS = ("best", "second", "nn", "colmin", "colarg")


def views(n: int, k: int, seed: int, flips: int = 40, valid: float = 0.85, empty=()):
    """n views of k descriptors: each a shuffled copy of one pool of k rows
    with `flips` random bits flipped per row, so that every pair shares
    correspondences; (n, k, 16) int32 and (n, k) bool, the views in
    `empty` with no valid slot."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, size=(k, 16), dtype=np.uint32)
    pool[:, -1] &= (1 << 6) - 1
    out = np.empty((n, k, 16), np.uint32)
    for i in range(n):
        d = pool[rng.permutation(k)].copy()
        bits = rng.integers(0, 486, size=(k, flips))
        for j in range(flips):
            d[np.arange(k), bits[:, j] // 32] ^= (np.uint32(1) << (bits[:, j] % 32).astype(np.uint32))
        out[i] = d
    v = rng.random((n, k)) < valid
    v[list(empty)] = False
    return torch.from_numpy(out.view(np.int32)), torch.from_numpy(v)


def all_pairs(n: int) -> list:
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


TABLES = {
    "all_10": (5, all_pairs(5)),
    "repeated": (5, [(0, 1), (2, 3), (0, 1), (2, 3), (0, 1)]),
    "self": (5, [(2, 2), (0, 0), (1, 2)]),
    "empty_view": (5, [(3, 0), (0, 3), (3, 3), (1, 4)]),
    "no_pair": (5, []),
    "other_set": (3, [(0, 4), (2, 0), (1, 1), (2, 4)]),
}


def _table(pairs) -> torch.Tensor:
    return torch.tensor(pairs, dtype=torch.int32).reshape(-1, 2)


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("case", list(TABLES))
def test_plain_twin_equals_reference_pair_by_pair(case, mutual):
    na, pairs = TABLES[case]
    d, v = views(5, 64, seed=len(pairs) + 7 * mutual, empty=(3,))
    da, va = d[:na], v[:na]
    table = _table(pairs)
    cfg = MatchConfig(mutual=mutual)
    m = match_fn(da, va, d, v, cfg, pairs=table)
    assert m.idx_b.shape == (len(pairs), 64)
    for p, (i, j) in enumerate(pairs):
        ref = ref_match.match(da[i : i + 1], va[i : i + 1], d[j : j + 1], v[j : j + 1], mutual=mutual)
        assert torch.equal(m.idx_b[p], ref["idx_b"][0]), p
        assert torch.equal(m.distance[p], ref["distance"][0]), p
        assert torch.equal(m.accepted[p], ref["accepted"][0]), p
    if case == "all_10":
        assert int(m.accepted.sum()) > 0
    a, b = table[:, 0].long(), table[:, 1].long()
    got = match_reduce_plain(da, va, d, v, table)
    for name, g, r in zip(OUTPUTS, got, match_reduce_plain(da[a], va[a], d[b], v[b])):
        assert torch.equal(g, r), name
    host = match(da.numpy().view(np.uint32), va.numpy(), d, v, cfg, device="cpu", pairs=table)
    assert torch.equal(host.idx_b, m.idx_b) and torch.equal(host.accepted, m.accepted)


def _bad(fault: str):
    good = _table(all_pairs(5))
    return {
        "int64": good.long(),
        "float": good.float(),
        "not_contiguous": good.t().contiguous().t(),
        "three_columns": torch.zeros((4, 3), dtype=torch.int32),
        "one_dim": good.reshape(-1),
        "three_dim": good[None],
        "negative": _table([(0, 1), (-1, 2)]),
        "past_a": _table([(0, 1), (5, 2)]),
        "past_b": _table([(0, 5)]),
        "past_a_set": _table([(3, 0)]),  # the A set below holds 3 views
        "other_device": good.to("meta"),
        "numpy_int64": good.numpy().astype(np.int64),
        "numpy_not_contiguous": np.asfortranarray(good.numpy()),
        "list": all_pairs(5),
        "too_many": torch.zeros((65536, 2), dtype=torch.int32),
    }[fault]


FAULTS = ["int64", "float", "not_contiguous", "three_columns", "one_dim", "three_dim", "negative", "past_a",
          "past_b", "past_a_set", "other_device", "numpy_int64", "numpy_not_contiguous", "list", "too_many"]


@pytest.mark.parametrize("fault", FAULTS)
def test_malformed_table_is_refused(fault):
    d, v = views(5, 32, seed=3)
    na = 3 if fault == "past_a_set" else 5
    bad = _bad(fault)
    with pytest.raises(ValueError):
        match_fn(d[:na], v[:na], d, v, MatchConfig(), pairs=bad)
    if isinstance(bad, torch.Tensor):
        with pytest.raises(ValueError):
            match_reduce(d[:na], v[:na], d, v, bad)


def test_pair_table_keeps_device_copies_per_content():
    """Device copies are made once per content and device, the last eight
    kept; a copy carries the range read on the host ("meta" stands in for
    the card: no data moves)."""
    meta = torch.device("meta")
    host = _table(all_pairs(5))
    first = pair_table(host, 5, 5, meta)
    assert first.device == meta and first.shape == (10, 2)
    assert pair_table(host.clone(), 5, 5, meta) is first and pair_table(first, 5, 5, meta) is first
    with pytest.raises(ValueError):
        pair_table(first, 5, 4, meta)  # its range, read on the host, reaches B view 4
    for n in range(6, 14):
        pair_table(_table(all_pairs(n)), 13, 13, meta)
    assert pair_table(host, 5, 5, meta) is not first  # evicted, copied anew
    assert pair_table(host, 5, 5, "cpu") is host  # a host table stays where it is


def _gathered(da, va, db, vb, table):
    a, b = table[:, 0].long(), table[:, 1].long()
    return da[a].contiguous(), va[a].contiguous(), db[b].contiguous(), vb[b].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,pairs", [(8, 1024, all_pairs(8) + [(3, 3), (0, 1), (7, 0)]), (30, 8192, all_pairs(30))],
                         ids=["k1024", "k8192_p435"])
def test_kernel_over_table_equals_gathered(cuda, n, k, pairs):
    d, v = views(n, k, seed=k + n, empty=(1,))
    d, v = d.to(cuda), v.to(cuda)
    table = pair_table(_table(pairs), n, n, cuda)
    assert table.device == cuda and pair_table(_table(pairs), n, n, cuda) is table  # cached per content
    _build.reset_launches()
    got = match_reduce(d, v, d, v, table)
    torch.cuda.synchronize()
    assert _build.launches["match"] == 1
    assert _build.counts["match_pairs"] == len(pairs) and _build.counts["match_slot_pairs"] == len(pairs) * k * k
    for name, g, r in zip(OUTPUTS, got, match_reduce(*_gathered(d, v, d, v, table))):
        assert torch.equal(g, r), name


@pytest.mark.gpu
def test_match_over_table_is_one_launch(cuda):
    """`match` over all 435 pairs of 30 views of 8,192 slots: one kernel-4
    launch per call, and the results of the plain twin on the card."""
    d, v = views(30, 8192, seed=5)
    d, v = d.to(cuda), v.to(cuda)
    table = _table(all_pairs(30))
    cfg = MatchConfig()
    match(d, v, d, v, cfg, device=cuda, pairs=table)
    _build.reset_launches()
    for _ in range(3):
        m = match(d, v, d, v, cfg, device=cuda, pairs=table)
    torch.cuda.synchronize()
    assert _build.launches["match"] == 3
    rows = [0, 14, 434]
    sub = _table([all_pairs(30)[p] for p in rows])
    mp = match_fn(d, v, d, v, cfg, plain=True, pairs=sub)
    for key in ("idx_b", "distance", "accepted"):
        assert torch.equal(getattr(m, key)[rows], getattr(mp, key)), key
    assert int(m.accepted.sum()) > 0


@pytest.mark.gpu
def test_card_table_not_from_pair_table_is_refused(cuda):
    d, v = views(5, 64, seed=1)
    d, v = d.to(cuda), v.to(cuda)
    with pytest.raises(ValueError):
        match_reduce(d, v, d, v, _table(all_pairs(5)).to(cuda))
    with pytest.raises(ValueError):
        match_fn(d, v, d, v, MatchConfig(), pairs=_table(all_pairs(5)).to(cuda))
