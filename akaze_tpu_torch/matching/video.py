"""Batched video front end: chunked extraction, consecutive matching and
keyframe selection (counterpart of the JAX package's
`akaze_tpu/matching/video.py`).

    res = process_video(frames)  # (T, H, W) -> VideoResult, on "cuda"

The frames stay on the device: chunks of `batch` frames go through
`extract_batch_fn` (kernels 1-3), all T - 1 consecutive pairs through one
batched `match_fn` (kernel 4), then the keyframe loop matches each frame
against the last keyframe (kernel 4, one pair per frame).  The loop's state
(keyframe descriptors and validity, reference count, age) lives in device
tensors updated with `torch.where`, so the loop reads nothing back to the
host; only the final per-frame counts and flags go to the host.

Keyframe rule: frame t becomes a keyframe when its matches to the last
keyframe fall below `keyframe_min_tracked` times the reference count (the
keyframe's match count one frame after its insertion).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, SfmConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.core.types import Features, Keypoints
from akaze_tpu_torch.frontend.pipeline import _as_tensor, extract_batch_fn
from akaze_tpu_torch.matching.hamming import Matches, match_fn
from akaze_tpu_torch.utils.profiling import check_no_nan


@dataclasses.dataclass
class VideoResult:
    """Result of a sequence run: features and matches on the device, the
    per-frame counts and the keyframes on the host."""

    features: Features  # (T, K) leaves
    match_counts: np.ndarray  # (T,) matches to the previous frame (0 for t = 0)
    keyframes: List[int]  # selected keyframe indices
    matches_prev: Matches  # (T, K) per-frame matches to the previous frame
    kf_match_counts: np.ndarray  # (T,) matches to the active keyframe


def extract_frames(frames: torch.Tensor, config: AkazeConfig, batch: int, plain: bool = False) -> Features:
    """`extract_batch_fn` over chunks of `batch` frames of a (T, H, W)
    tensor (the last chunk may be smaller), concatenated to (T, K) leaves."""
    chunks = [extract_batch_fn(frames[i : i + batch], config, plain=plain)
              for i in range(0, frames.shape[0], batch)]
    kp = Keypoints(**{f.name: torch.cat([getattr(c.keypoints, f.name) for c in chunks])
                      for f in dataclasses.fields(Keypoints)})
    return Features(kp, torch.cat([c.descriptors for c in chunks]))


def consecutive_matches(feats: Features, mconfig: MatchConfig, plain: bool = False) -> Matches:
    """Matches of every frame to the previous one, (T, K), from one batched
    `match_fn` over the T - 1 pairs.  Frame 0 has no predecessor: its row
    is idx_b = 0, distance = 0, accepted = False, as in the reference."""
    d, v = feats.descriptors, feats.keypoints.valid
    zero = torch.zeros((1, d.shape[1]), dtype=torch.int32, device=d.device)
    if d.shape[0] < 2:
        return Matches(idx_b=zero, distance=zero, accepted=zero.bool())
    m = match_fn(d[:-1], v[:-1], d[1:], v[1:], mconfig, plain=plain)
    return Matches(idx_b=torch.cat([zero, m.idx_b]), distance=torch.cat([zero, m.distance]),
                   accepted=torch.cat([zero.bool(), m.accepted]))


def select_keyframes(feats: Features, mconfig: MatchConfig, sconfig: SfmConfig, plain: bool = False):
    """The keyframe loop: each frame t >= 1 matched against the current
    keyframe.  Returns (T,) int32 match counts to the keyframe (0 for t = 0)
    and (T,) bool keyframe flags (False for t = 0), both on the device.
    Issues no host synchronization."""
    desc, valid = feats.descriptors, feats.keypoints.valid
    kf_desc, kf_valid = desc[0], valid[0]
    ref = torch.ones((), dtype=torch.int32, device=desc.device)
    age = torch.ones((), dtype=torch.int32, device=desc.device)
    counts = [torch.zeros((), dtype=torch.int32, device=desc.device)]
    flags = [torch.zeros((), dtype=torch.bool, device=desc.device)]
    for t in range(1, desc.shape[0]):
        c = match_fn(kf_desc, kf_valid, desc[t], valid[t], mconfig, plain=plain).count()
        ref = torch.where(age == 1, torch.clamp(c, min=1), ref)
        tracked = c.to(torch.float32) / ref.to(torch.float32)
        is_kf = (age >= 1) & (tracked < sconfig.keyframe_min_tracked)
        kf_desc = torch.where(is_kf, desc[t], kf_desc)
        kf_valid = torch.where(is_kf, valid[t], kf_valid)
        age = torch.where(is_kf, 0, age) + 1
        counts.append(c)
        flags.append(is_kf)
    return torch.stack(counts), torch.stack(flags)


def track_fn(feats: Features, mconfig: MatchConfig, sconfig: SfmConfig, plain: bool = False) -> VideoResult:
    """Consecutive matching and keyframe selection on (T, K) features."""
    matches = consecutive_matches(feats, mconfig, plain)
    kf_counts, is_kf = select_keyframes(feats, mconfig, sconfig, plain)
    counts = matches.count().cpu().numpy()
    is_kf = is_kf.cpu().numpy()
    return VideoResult(
        features=feats,
        match_counts=counts,
        keyframes=[0] + [int(t) for t in np.nonzero(is_kf)[0]],
        matches_prev=matches,
        kf_match_counts=kf_counts.cpu().numpy(),
    )


def process_video_fn(frames: torch.Tensor, config: AkazeConfig, mconfig: MatchConfig, sconfig: SfmConfig,
                     batch: int = 8, plain: bool = False) -> VideoResult:
    """The video front end on a (T, H, W) tensor on its device.
    plain=True runs the plain twins of the kernels on any device (for
    comparisons)."""
    if frames.ndim != 3:
        raise ValueError(f"process_video expects (T, H, W) frames, got shape {tuple(frames.shape)}")
    return track_fn(extract_frames(frames, config, batch, plain), mconfig, sconfig, plain)


def process_video(frames, config: AkazeConfig | None = None, mconfig: MatchConfig | None = None,
                  sconfig: SfmConfig | None = None, batch: int = 8, device="cuda") -> VideoResult:
    """Run the video front end over (T, H, W) frames (tensor or numpy; float
    in [0, 1] or integer) on `device`.  A tensor already on the device is
    not copied."""
    config = config or AkazeConfig()
    # Tracking gates on absolute Hamming distance as well: genuine
    # frame-to-frame matches sit far below 120 of 486 bits, while ratio and
    # mutual checks alone let random cross-scene matches through, which
    # would hide scene cuts from the keyframe rule.
    mconfig = mconfig or MatchConfig(max_distance=120)
    sconfig = sconfig or SfmConfig()
    res = process_video_fn(_as_tensor(frames, resolve_device(device)), config, mconfig, sconfig, batch)
    kp = res.features.keypoints
    check_no_nan("process_video", kp.x, kp.y, kp.response, kp.size, kp.angle)
    return res
