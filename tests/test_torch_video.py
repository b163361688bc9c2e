"""The port's video front end (`akaze_tpu_torch/matching/video.py`) against
the JAX package's `process_video` on the CPU, on tests/test_video.py's two
sequences (10 frames of 120x160, seed 5; and 4 + 4 frames across a scene
cut).

- Tracking on identical features: JAX's features, passed through
  `interop.features_from_numpy`, go through the port's consecutive match and
  keyframe loop; match counts, keyframe counts, keyframes and the
  per-frame matches must be exactly equal.
- End to end on the port's own extract: keyframes equal, total accepted
  matches within 5 % (the slice's gate)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import SfmConfig as JaxSfmConfig
from akaze_tpu.matching.video import process_video as jax_process_video
from akaze_tpu.utils.synthetic import video_sequence
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, SfmConfig
from akaze_tpu_torch.matching import video

torch.set_num_threads(2)

# tests/test_video.py's configuration.
CFG = dict(max_keypoints=256, per_level_candidates=64, detector_threshold=1e-4)


def _sequence(name):
    if name == "pan":
        return video_sequence(10, 120, 160, seed=5), 0.6
    a = video_sequence(4, 120, 160, seed=5)
    b = np.flip(video_sequence(4, 120, 160, seed=99), axis=(1, 2)).copy()
    return np.concatenate([a, b]), 0.7


@pytest.fixture(scope="module", params=["pan", "cut"])
def sequence(request):
    """(frames, keyframe_min_tracked, JAX result, JAX features as numpy)."""
    frames, kmt = _sequence(request.param)
    ref = jax_process_video(frames, JaxAkazeConfig(**CFG), sconfig=JaxSfmConfig(keyframe_min_tracked=kmt), batch=4)
    kp = ref.features.keypoints
    arrays = {f.name: np.asarray(getattr(kp, f.name)) for f in dataclasses.fields(kp)}
    arrays["descriptors"] = np.asarray(ref.features.descriptors)
    return frames, kmt, ref, arrays


def test_tracking_on_jax_features_equals_jax(sequence):
    _, kmt, ref, arrays = sequence
    feats = interop.features_from_numpy(arrays, device="cpu")
    got = video.track_fn(feats, MatchConfig(max_distance=120), SfmConfig(keyframe_min_tracked=kmt))
    assert got.keyframes == ref.keyframes
    np.testing.assert_array_equal(got.match_counts, ref.match_counts)
    np.testing.assert_array_equal(got.kf_match_counts, np.asarray(ref.kf_match_counts))
    for name in ("idx_b", "distance", "accepted"):
        np.testing.assert_array_equal(getattr(got.matches_prev, name).numpy(),
                                      np.asarray(getattr(ref.matches_prev, name)), err_msg=name)
    # Frame 0's row, as the reference has it.
    assert not got.matches_prev.accepted[0].any()
    assert (got.matches_prev.idx_b[0] == 0).all() and (got.matches_prev.distance[0] == 0).all()


def test_process_video_end_to_end_matches_jax(sequence):
    frames, kmt, ref, _ = sequence
    got = video.process_video(frames, AkazeConfig(**CFG), sconfig=SfmConfig(keyframe_min_tracked=kmt), batch=4,
                              device="cpu")
    assert got.keyframes == ref.keyframes
    total_ref, total_got = int(ref.match_counts.sum()), int(got.match_counts.sum())
    assert total_ref > 100
    assert abs(total_got - total_ref) <= 0.05 * total_ref, (total_got, total_ref)
    assert got.features.descriptors.shape == (len(frames), CFG["max_keypoints"], 16)
    assert got.match_counts[0] == 0 and got.kf_match_counts[0] == 0


def test_chunking_does_not_change_the_result():
    """A tail chunk smaller than the batch, and one chunk for the whole
    sequence, give the same result bit for bit."""
    frames = torch.from_numpy(video_sequence(5, 120, 160, seed=3))
    args = (AkazeConfig(**CFG), MatchConfig(max_distance=120), SfmConfig())
    a = video.process_video_fn(frames, *args, batch=2)  # chunks of 2, 2, 1
    b = video.process_video_fn(frames, *args, batch=8)
    assert a.keyframes == b.keyframes
    np.testing.assert_array_equal(a.match_counts, b.match_counts)
    np.testing.assert_array_equal(a.kf_match_counts, b.kf_match_counts)
    assert torch.equal(a.features.descriptors, b.features.descriptors)
    assert torch.equal(a.matches_prev.accepted, b.matches_prev.accepted)
    assert (a.match_counts[1:] > 10).all()


def test_one_frame_and_the_default_device():
    frames = video_sequence(2, 120, 160, seed=1)
    one = video.process_video(frames[:1], AkazeConfig(**CFG), device="cpu")
    assert one.keyframes == [0] and one.match_counts.tolist() == [0] and one.kf_match_counts.tolist() == [0]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        video.process_video(frames)
