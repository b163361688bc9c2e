"""Fixed-capacity structure-of-arrays containers of the port.

A frame's keypoints live in (..., M) tensors with a `valid` mask (slots
are not compacted: a sub-pixel rejection leaves an invalid slot inside the
prefix).  Descriptors are (..., M, 16) int32 tensors holding the same bit
patterns as the JAX package's uint32 words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from akaze_tpu_torch.core.device import resolve_device


@dataclasses.dataclass
class Keypoints:
    """(x, y) in octave-0 pixels, det-Hessian `response`, `size` (esigma *
    derivative_factor), `octave`, `class_id` (level index), `angle` (rad)."""

    x: torch.Tensor  # f32 (..., M)
    y: torch.Tensor  # f32 (..., M)
    response: torch.Tensor  # f32 (..., M)
    size: torch.Tensor  # f32 (..., M)
    octave: torch.Tensor  # i32 (..., M)
    class_id: torch.Tensor  # i32 (..., M)
    angle: torch.Tensor  # f32 (..., M)
    valid: torch.Tensor  # bool (..., M)

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> torch.Tensor:
        """Number of valid keypoints (int32, one per leading index)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)

    def index(self, i) -> "Keypoints":
        """Keypoints of leading index `i` (e.g. one frame of a batch)."""
        return Keypoints(**{f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Features:
    """Keypoints + packed binary descriptors (int32 words, 486 bits used)."""

    keypoints: Keypoints
    descriptors: torch.Tensor  # i32 (..., M, W)

    @property
    def capacity(self) -> int:
        return self.keypoints.capacity

    def index(self, i) -> "Features":
        return Features(self.keypoints.index(i), self.descriptors[i])


def empty_keypoints(capacity: int, batch: tuple = (), device="cuda") -> Keypoints:
    """All-zero, all-invalid keypoints of shape (*batch, capacity) on
    `device` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    shape = (*batch, capacity)
    f32 = torch.zeros(shape, dtype=torch.float32, device=device)
    i32 = torch.zeros(shape, dtype=torch.int32, device=device)
    return Keypoints(
        x=f32, y=f32.clone(), response=f32.clone(), size=f32.clone(),
        octave=i32, class_id=i32.clone(), angle=f32.clone(),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def keypoints_to_numpy(kps: Keypoints) -> dict[str, np.ndarray]:
    """Every field of `kps` as a numpy array (copied to the host)."""
    return {f.name: getattr(kps, f.name).cpu().numpy() for f in dataclasses.fields(kps)}
