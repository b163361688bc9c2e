"""Golden NumPy brute-force Hamming matcher (own copy of the JAX
package's `golden/matching.py` on the port's `MatchConfig`).

For each descriptor in A: argmin over B of popcount(a XOR b), with
Lowe-ratio and mutual-best filtering.  Oracle for kernel 4's matcher.
"""

from __future__ import annotations

import numpy as np

from akaze_tpu_torch.core.config import MatchConfig


def hamming_distance_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: uint32 (N, W), b: uint32 (M, W) -> int32 (N, M) Hamming distances."""
    xor = a[:, None, :] ^ b[None, :, :]
    return np.bitwise_count(xor).sum(axis=-1).astype(np.int32)


def match(a: np.ndarray, b: np.ndarray, config: MatchConfig | None = None) -> np.ndarray:
    """Returns int64 (K, 2) array of (index_a, index_b) accepted matches."""
    config = config or MatchConfig()
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64)
    d = hamming_distance_matrix(a, b)
    nn_b = np.argmin(d, axis=1)
    best = d[np.arange(d.shape[0]), nn_b]
    # Second-best for the ratio test.
    d2 = d.copy()
    d2[np.arange(d.shape[0]), nn_b] = np.iinfo(np.int32).max
    second = d2.min(axis=1)
    ok = best <= config.max_distance
    ok &= best < config.ratio * second
    if config.mutual:
        nn_a = np.argmin(d, axis=0)
        ok &= nn_a[nn_b] == np.arange(d.shape[0])
    idx_a = np.nonzero(ok)[0]
    return np.stack([idx_a, nn_b[idx_a]], axis=1).astype(np.int64)
