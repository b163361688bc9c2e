"""Checkpoint / resume of the SfM map state (own copy of the JAX package's
`akaze_tpu/sfm/checkpoint.py`, same file format).

Poses, points, track bookkeeping and the keyframe list go into one
versioned .npz, so a checkpoint written by either package loads in the
other.  A run that stops resumes from `next_keyframe`: the incremental
loop is idempotent per keyframe.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List

import numpy as np

CHECKPOINT_SCHEMA_VERSION = 1


@dataclasses.dataclass
class SfmCheckpoint:
    poses: np.ndarray  # (K, 6)
    points: np.ndarray  # (P, 3)
    track_point: Dict[int, int]
    keyframe_frames: List[int]
    next_keyframe: int  # first keyframe index not yet processed


def save_checkpoint(path, ckpt: SfmCheckpoint) -> None:
    """Write `ckpt` to `path` (through a temporary file and a rename)."""
    path = pathlib.Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    track_items = np.asarray(sorted(ckpt.track_point.items()), np.int64).reshape(-1, 2)
    np.savez_compressed(
        tmp,
        schema_version=CHECKPOINT_SCHEMA_VERSION,
        poses=np.asarray(ckpt.poses, np.float32),
        points=np.asarray(ckpt.points, np.float32),
        track_items=track_items,
        keyframe_frames=np.asarray(ckpt.keyframe_frames, np.int64),
        next_keyframe=np.int64(ckpt.next_keyframe),
    )
    # np.savez appends .npz to names without it; normalize, then rename.
    written = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    written.replace(path)


def load_checkpoint(path) -> SfmCheckpoint:
    with np.load(path) as z:
        version = int(z["schema_version"])
        if version != CHECKPOINT_SCHEMA_VERSION:
            raise ValueError(f"checkpoint schema {version} != supported {CHECKPOINT_SCHEMA_VERSION}")
        track_items = z["track_items"]
        return SfmCheckpoint(
            poses=z["poses"],
            points=z["points"],
            track_point={int(a): int(b) for a, b in track_items},
            keyframe_frames=[int(x) for x in z["keyframe_frames"]],
            next_keyframe=int(z["next_keyframe"]),
        )
