"""The port's loop closure (`akaze_tpu_torch/sfm/loop_closure.py`) against
the JAX package's on the CPU: track merging exactly equal (the cases of
tests/test_loop_closure.py and a random closure set), pair counts equal,
and detect_loop_closures on tests/test_loop_closure.py's revisit sequence,
fed JAX's features and JAX's random draws: the same (i, j) list, inlier
counts within 1 % and the same inlier matches.  The closures' relative
poses are not compared: the crops are image shifts of one textured plane,
for which the essential matrix is degenerate (R ~ I, t undetermined), so
either package's t follows float32 rounding."""

import dataclasses

import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.frontend.pipeline import extract_batch as jax_extract_batch
from akaze_tpu.sfm import loop_closure as JL
from akaze_tpu.utils.synthetic import textured_scene
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import MatchConfig
from akaze_tpu_torch.sfm import loop_closure as TL

torch.set_num_threads(2)
INTR = (160.0, 160.0, 80.0, 60.0)
KW = dict(min_gap=5, min_matches=40, min_inliers=20)


@pytest.fixture(scope="module")
def revisit():
    """tests/test_loop_closure.py's sequence: leaves at t = 3 and returns at
    t = 7; JAX's features, and the same as the port's Features."""
    base = textured_scene(240, 480, seed=13)
    offs = [0, 2, 4, 150, 160, 170, 180, 4, 2, 0]
    frames = np.stack([base[60:180, o : o + 160] for o in offs])
    cfg = JaxAkazeConfig(max_keypoints=256, per_level_candidates=64, detector_threshold=1e-4)
    feats = jax_extract_batch(frames, cfg)
    kp = feats.keypoints
    arrays = {f.name: np.asarray(getattr(kp, f.name)) for f in dataclasses.fields(kp)}
    arrays["descriptors"] = np.asarray(feats.descriptors)
    return feats, interop.features_from_numpy(arrays, device="cpu")


@pytest.fixture(scope="module")
def jax_closures(revisit):
    return JL.detect_loop_closures(revisit[0], list(range(10)), INTR, **KW)


def test_detect_loop_closures_matches_jax(revisit, jax_closures):
    _, feats = revisit
    want = jax_closures
    got = TL.detect_loop_closures(feats, list(range(10)), INTR, draws=interop.jax_uniform, **KW)
    assert want and [(c.i, c.j) for c in got] == [(c.i, c.j) for c in want]
    assert all(c.i <= 2 and c.j >= 7 for c in got)
    for g, w in zip(got, want):
        assert abs(g.num_inliers - w.num_inliers) <= max(1, 0.01 * w.num_inliers)
        if g.num_inliers == w.num_inliers:
            np.testing.assert_array_equal(g.matches, w.matches)
        assert g.rel6.shape == (6,) and g.rel6.dtype == np.float32 and np.isfinite(g.rel6).all()
    # The port's own generator finds the same closures on this sequence.
    own = TL.detect_loop_closures(feats, list(range(10)), INTR, **KW)
    assert [(c.i, c.j) for c in own] == [(c.i, c.j) for c in want]


def test_pair_counts_equal_jax_one_kernel_call_per_chunk(revisit):
    jax_feats, feats = revisit
    pairs = np.array([(a, b) for a in range(10) for b in range(a + 1, 10)], np.int64)
    cfg = dict(max_distance=120)
    want = JL.pairwise_match_counts(jax_feats.descriptors, jax_feats.keypoints.valid, pairs, JaxMatchConfig(**cfg))
    calls = []
    real = TL.match_fn
    TL.match_fn = lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k)
    try:
        got = TL.pairwise_match_counts(feats.descriptors, feats.keypoints.valid, pairs, MatchConfig(**cfg), chunk=16)
    finally:
        TL.match_fn = real
    np.testing.assert_array_equal(got, want)
    assert calls == [16, 16, 16, 16]  # 45 pairs padded to 64, one batched call per chunk
    assert TL.pairwise_match_counts(feats.descriptors, feats.keypoints.valid, pairs[:0]).shape == (0,)


def _closure(i, j, matches):
    return dict(i=i, j=j, matches=np.asarray(matches, np.int64).reshape(-1, 2), rel6=np.zeros(6, np.float32),
                num_inliers=50)


def _random_case(seed):
    rng = np.random.default_rng(seed)
    tracks = []
    for _ in range(40):
        start = int(rng.integers(0, 12))
        n = int(rng.integers(2, 5))
        tracks.append({f: int(rng.integers(0, 30)) for f in range(start, start + n)})
    closures = [_closure(int(i), int(i) + 8, rng.integers(0, 30, (12, 2))) for i in rng.integers(0, 4, 4)]
    return tracks, closures


@pytest.mark.parametrize("case", ["unions", "new track", "random 1", "random 2"])
def test_merge_closure_tracks_equals_jax(case):
    if case == "unions":
        tracks, closures = [{0: 5, 1: 7}, {8: 3, 9: 4}, {1: 9, 2: 2}], [_closure(0, 8, [[5, 3]])]
    elif case == "new track":
        tracks, closures = [], [_closure(2, 11, [[1, 2], [3, 4]])]
    else:
        tracks, closures = _random_case(int(case[-1]))
    got = TL.merge_closure_tracks(tracks, interop.closures_from_fields(closures))
    want = JL.merge_closure_tracks(tracks, [JL.Closure(**c) for c in closures])
    assert got == want
    if case == "unions":
        assert {0: 5, 1: 7, 8: 3, 9: 4} in got and {1: 9, 2: 2} in got


def test_closures_round_trip_through_fields(jax_closures):
    want = jax_closures[:2]
    port = interop.closures_from_fields([dataclasses.asdict(c) for c in want])
    assert all(isinstance(c, TL.Closure) for c in port)
    back = [JL.Closure(**dataclasses.asdict(c)) for c in port]
    for a, b in zip(back, want):
        assert (a.i, a.j, a.num_inliers) == (b.i, b.j, b.num_inliers)
        np.testing.assert_array_equal(a.matches, b.matches)
        np.testing.assert_array_equal(a.rel6, b.rel6)
