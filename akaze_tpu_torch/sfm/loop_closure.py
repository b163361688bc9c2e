"""Loop-closure detection over a keyframe database and track merging
(counterpart of the JAX package's `akaze_tpu/sfm/loop_closure.py`).

The keyframe database is the (T, cap, 16) descriptor tensor of the video
front end.  Candidates are found by matching every admissible keyframe
pair: the pair list goes in chunks of `chunk` pairs, each chunk one batched
`match_fn` call (one kernel-4 launch) over gathered descriptor stacks, and
all counts come back to the host in one read.  The strong pairs are
re-matched in the same way and verified by the RANSAC essential solve
(`estimate_relative_pose_fn`, a batch of pairs per call).

Outputs feed two consumers:
  * `merge_closure_tracks` unions matched keypoints into the track set, so
    bundle adjustment sees revisited points as the same 3D points;
  * `Closure.rel6` (cam_j-from-cam_i, unit-scale translation) becomes a
    pose-graph edge in `sfm.incremental`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from akaze_tpu_torch.core.config import MatchConfig, RansacConfig
from akaze_tpu_torch.core.device import upload
from akaze_tpu_torch.geometry.twoview import estimate_relative_pose_fn, normalize_points
from akaze_tpu_torch.matching.hamming import Matches, match_fn
from akaze_tpu_torch.sfm.rotations import matrix_to_rotvec
from akaze_tpu_torch.utils.profiling import check_no_nan


@dataclasses.dataclass
class Closure:
    """A verified loop closure between keyframes i < j (frame indices)."""

    i: int
    j: int
    matches: np.ndarray  # (M, 2) keypoint indices: column 0 in i, 1 in j
    rel6: np.ndarray  # (6,) measured cam_j-from-cam_i [rotvec|t], |t| = 1
    num_inliers: int


def _match_pairs(desc, valid, idx: torch.Tensor, mconfig: MatchConfig, chunk: int) -> List[Matches]:
    """Matches of the pairs (G, 2) of frame indices, one batched `match_fn`
    call per chunk of `chunk` pairs."""
    out = []
    for c0 in range(0, idx.shape[0], chunk):
        a, b = idx[c0 : c0 + chunk, 0], idx[c0 : c0 + chunk, 1]
        out.append(match_fn(desc[a], valid[a], desc[b], valid[b], mconfig))
    return out


def pairwise_match_counts(desc, valid, pairs: np.ndarray, mconfig: MatchConfig | None = None,
                          chunk: int = 32) -> np.ndarray:
    """Match counts of a list of keyframe index pairs (G, 2), on the
    descriptors' device: desc (T, cap, 16) int32, valid (T, cap).

    The pair list is bucket-padded to a power of two (repeating the first
    pair), as in the reference, and goes through kernel 4 one chunk of
    pairs per launch; one host read at the end."""
    mconfig = mconfig or MatchConfig(max_distance=120)
    g = len(pairs)
    if g == 0:
        return np.zeros(0, np.int32)
    bucket = max(chunk, 1 << (g - 1).bit_length())
    padded = np.concatenate([pairs, np.repeat(pairs[:1], bucket - g, axis=0)])
    ms = _match_pairs(desc, valid, upload(padded.astype(np.int64), desc.device), mconfig, chunk)
    return torch.cat([m.count() for m in ms]).cpu().numpy()[:g]


def detect_loop_closures(
    features,
    keyframes: Sequence[int],
    intrinsics,
    mconfig: MatchConfig | None = None,
    rconfig: RansacConfig | None = None,
    min_gap: int = 8,
    min_matches: int = 60,
    min_inliers: int = 30,
    chunk: int = 32,
    draws=None,
) -> List[Closure]:
    """Match every admissible keyframe pair; RANSAC-verify the strong ones.

    features: `Features` with (T, cap) leaves on a device (the video front
    end's output); keyframes: the frame indices of the database;
    intrinsics (fx, fy, cx, cy) normalize the pixel keypoints for the
    essential-matrix check.

    Every candidate pair is verified with the same random scores, as the
    reference keys each pair's RANSAC with `PRNGKey(rconfig.seed)`: draws is
    a function (seed, (H, N)) -> array (`interop.jax_uniform` gives JAX's),
    and None draws them from a `torch.Generator` seeded with `rconfig.seed`."""
    mconfig = mconfig or MatchConfig(max_distance=120)
    rconfig = rconfig or RansacConfig(num_iterations=256, inlier_threshold=3e-3)
    kf = list(keyframes)
    pairs = np.array(
        [(kf[a], kf[b]) for a in range(len(kf)) for b in range(a + 1, len(kf)) if kf[b] - kf[a] >= min_gap],
        np.int64,
    ).reshape(-1, 2)
    desc, kp = features.descriptors, features.keypoints
    counts = pairwise_match_counts(desc, kp.valid, pairs, mconfig, chunk)
    cand = pairs[counts >= min_matches]
    if len(cand) == 0:
        return []
    dev = desc.device
    idx = upload(cand, dev)
    n = desc.shape[1]
    shape = (rconfig.num_iterations, n)
    if draws is None:
        scores = torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(rconfig.seed), device=dev)
    else:
        scores = upload(np.asarray(draws(rconfig.seed, shape), np.float32), dev)
    results = []
    for c0, m in zip(range(0, len(cand), chunk), _match_pairs(desc, kp.valid, idx, mconfig, chunk)):
        fi, fj = idx[c0 : c0 + chunk, 0], idx[c0 : c0 + chunk, 1]
        nb = m.idx_b.long()
        x1 = normalize_points(kp.x[fi], kp.y[fi], intrinsics)
        x2 = normalize_points(torch.gather(kp.x[fj], 1, nb), torch.gather(kp.y[fj], 1, nb), intrinsics)
        res = estimate_relative_pose_fn(x1, x2, m.accepted, rconfig,
                                        sample_scores=scores.expand(fi.shape[0], *shape))
        rel6 = torch.cat([matrix_to_rotvec(res.R), res.t], dim=-1)
        check_no_nan("detect_loop_closures", rel6)
        results.append((m.accepted, m.idx_b, res.inliers, res.num_inliers, rel6))
    acc, idx_b, inliers, n_inl, rel6 = (torch.cat(x).cpu().numpy() for x in zip(*results))
    closures: List[Closure] = []
    for c, (fi, fj) in enumerate(cand):
        if n_inl[c] < min_inliers:
            continue
        rows = np.nonzero(acc[c])[0]
        match_idx = np.stack([rows, idx_b[c][rows]], axis=1)[inliers[c][rows]]
        closures.append(Closure(i=int(fi), j=int(fj), matches=match_idx, rel6=rel6[c].astype(np.float32),
                                num_inliers=int(n_inl[c])))
    return closures


def merge_closure_tracks(tracks: List[Dict[int, int]], closures: Sequence[Closure]) -> List[Dict[int, int]]:
    """Union closure-matched keypoints into the consecutive-frame track set:
    a point revisited at a loop closure becomes one track observed from
    both visits."""
    owner: Dict[tuple, int] = {}
    merged = [dict(tr) for tr in tracks]
    for ti, tr in enumerate(merged):
        for f, kp in tr.items():
            owner[(f, kp)] = ti

    def find(ti):  # path-compressed union-find over track indices
        root = ti
        while isinstance(merged[root], int):
            root = merged[root]
        while isinstance(merged[ti], int):
            merged[ti], ti = root, merged[ti]
        return root

    for cl in closures:
        for a, b in cl.matches:
            ka, kb = (cl.i, int(a)), (cl.j, int(b))
            ta = owner.get(ka)
            tb = owner.get(kb)
            if ta is not None:
                ta = find(ta)
            if tb is not None:
                tb = find(tb)
            if ta is None and tb is None:
                ti = len(merged)
                merged.append({cl.i: int(a), cl.j: int(b)})
                owner[ka] = owner[kb] = ti
            elif ta is None:
                merged[tb].setdefault(cl.i, int(a))
                owner[ka] = tb
            elif tb is None:
                merged[ta].setdefault(cl.j, int(b))
                owner[kb] = ta
            elif ta != tb:
                # Merge the smaller into the larger; existing frames win.
                if len(merged[ta]) < len(merged[tb]):
                    ta, tb = tb, ta
                for f, kp in merged[tb].items():
                    merged[ta].setdefault(f, kp)
                merged[tb] = ta  # tombstone -> union-find parent
    return [tr for tr in merged if isinstance(tr, dict) and len(tr) >= 2]
