"""Brute-force Hamming matcher on packed descriptors (counterpart of the
JAX package's `akaze_tpu/matching/hamming.py`).

The distance reduction is kernel 4 (`kernels/match.py`); the ratio,
max-distance and mutual filters are PyTorch ops in float32, as in the
reference.  Pairs are a written-out leading batch axis in place of `vmap`,
or a pair table over sets of views (`pairs`): all the pairs of a set in
one kernel-4 launch, with no gathered copy of either side.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from akaze_tpu_torch.core.config import MatchConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain, pair_table
from akaze_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Matches:
    """For each query (row of A): best B index, its distance, and whether
    the match passed every filter."""

    idx_b: torch.Tensor  # i32 (..., Ka)
    distance: torch.Tensor  # i32 (..., Ka)
    accepted: torch.Tensor  # bool (..., Ka)

    def count(self) -> torch.Tensor:
        return self.accepted.sum(dim=-1, dtype=torch.int32)


def match_fn(desc_a, valid_a, desc_b, valid_b, config: MatchConfig, plain: bool = False,
             pairs=None) -> Matches:
    """Matcher core on tensors: (P, K, W) descriptors and (P, K) masks, or
    one pair without the leading axis.  With `pairs`, a (P, 2) int32 pair
    table (a CPU tensor, or a table of `kernels.match.pair_table`),
    the sides are sets of views, (NA, K, W) / (NA, K) and (NB, K, W) /
    (NB, K), and pair p matches A view pairs[p, 0] against B view
    pairs[p, 1]: (P, K) results from one kernel-4 launch.  plain=True runs
    the plain twin of the reduction on any device (for comparisons)."""
    single = desc_a.ndim == 2 and pairs is None
    if single:
        desc_a, valid_a, desc_b, valid_b = (x[None] for x in (desc_a, valid_a, desc_b, valid_b))
    reduce = match_reduce_plain if plain else match_reduce
    dev = desc_a.device
    with span("matching.match", dev):
        table = None
        if pairs is not None:
            with span("matching.table", dev):
                table = pair_table(pairs, desc_a.shape[0], desc_b.shape[0], dev)
        with span("matching.reduce", dev):
            best, second, nn_b, _, nn_a = reduce(
                desc_a.contiguous(), valid_a.contiguous(), desc_b.contiguous(), valid_b.contiguous(), table
            )
        with span("matching.filter", dev):
            rows = torch.arange(desc_a.shape[1], device=dev, dtype=torch.int32)
            if table is not None:
                valid_a = valid_a.index_select(0, table[:, 0])
            ok = valid_a & (best <= config.max_distance)
            ok &= best.to(torch.float32) < config.ratio * second.to(torch.float32)
            if config.mutual:
                ok &= torch.gather(nn_a, 1, nn_b.long()) == rows
    m = Matches(idx_b=nn_b, distance=best, accepted=ok)
    if single:
        m = Matches(m.idx_b[0], m.distance[0], m.accepted[0])
    return m


def _as_descriptors(d, device) -> torch.Tensor:
    if isinstance(d, np.ndarray):
        d = torch.from_numpy(np.ascontiguousarray(d).view(np.int32))
    return d.to(device=device, dtype=torch.int32)


def match(desc_a, valid_a, desc_b, valid_b, config: MatchConfig | None = None,
          device="cuda", pairs=None) -> Matches:
    """Match descriptor sets A against B on `device`.

    Descriptors are int32 tensors or uint32/int32 numpy arrays, (K, W) or
    batched (P, K, W); the inputs move to `device`.  With `pairs`, a (P, 2)
    int32 CPU tensor, A and B are sets of views (N, K, W) and pair p
    matches A view pairs[p, 0] against B view pairs[p, 1] (`match_fn`)."""
    config = config or MatchConfig()
    device = resolve_device(device)
    va = torch.as_tensor(valid_a).to(device=device, dtype=torch.bool)
    vb = torch.as_tensor(valid_b).to(device=device, dtype=torch.bool)
    return match_fn(_as_descriptors(desc_a, device), va, _as_descriptors(desc_b, device), vb, config,
                    pairs=pairs)


def match_features(feat_a, feat_b, config: MatchConfig | None = None, device="cuda") -> Matches:
    """Convenience wrapper over two `Features`."""
    return match(
        feat_a.descriptors, feat_a.keypoints.valid,
        feat_b.descriptors, feat_b.keypoints.valid,
        config, device,
    )
