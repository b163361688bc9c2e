"""Configuration dataclasses of the PyTorch port (own copy of the JAX
package's `akaze_tpu/core/config.py`: `AkazeConfig`, `MatchConfig`,
`RansacConfig`, `SfmConfig` and `MeshConfig`, same fields and defaults).

The TPU execution knobs (`pallas_octaves`, `patch_backend`,
`describe_group`, `describe_loop`, `deep_octave_frames`,
`MatchConfig.backend`) are kept as fields so that a configuration converts
field for field between the two packages; the port reads none of them.  It
reads `describe_backend` as the JAX package does on a TPU ("auto" and
"fused": the fused describe kernel; "xla" and "pallas": the non-fused
chunked describe), and no environment variable.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Diffusivity(enum.Enum):
    """Conductivity function used by the nonlinear diffusion."""

    PM_G1 = "pm_g1"
    PM_G2 = "pm_g2"
    WEICKERT = "weickert"


@dataclasses.dataclass(frozen=True)
class AkazeConfig:
    """AKAZE front-end options (4 octaves x 4 sublevels, sigma0 = 1.6,
    detector threshold 1e-3, contrast percentile 0.7 over 300 bins, PM-g2,
    486-bit M-LDB with pattern size 10)."""

    num_octaves: int = 4
    num_sublevels: int = 4
    base_scale_offset: float = 1.6
    derivative_factor: float = 1.5
    detector_threshold: float = 1e-3
    initial_contrast: float = 1e-3
    contrast_percentile: float = 0.7
    contrast_nbins: int = 300
    contrast_fallback: float = 0.03
    contrast_octave_decay: float = 0.75
    diffusivity: Diffusivity = Diffusivity.PM_G2
    fed_tau_max: float = 0.25
    min_octave_dim: int = 40
    descriptor_channels: int = 3
    descriptor_pattern_size: int = 10
    border_smax: float = 10.0 * math.sqrt(2.0)
    dedup_radius_factor: float = 0.5
    # Fixed keypoint capacity per frame (SoA top-M with a validity mask).
    max_keypoints: int = 1024
    # Raw extrema kept per level before cross-level NMS (exact top-K).
    per_level_candidates: int = 256
    # TPU-only knobs, kept for 1:1 conversion; not read by the port (the
    # port's candidate top-K is exact, i.e. recall 1.0).
    candidate_recall: float = 0.95
    pallas_octaves: int = 4
    patch_backend: str = "auto"
    # Describe branch of extract_batch: "auto" / "fused" (kernel 3), "xla" /
    # "pallas" (the non-fused chunked describe, patches from kernel 7).
    describe_backend: str = "auto"
    describe_group: int = 8
    describe_loop: str = "map"
    deep_octave_frames: int = 8

    @property
    def num_levels(self) -> int:
        return self.num_octaves * self.num_sublevels

    @property
    def descriptor_bits(self) -> int:
        """486 = 3 channels * (C(4,2) + C(9,2) + C(16,2))."""
        n = 0
        for cells in (4, 9, 16):
            n += cells * (cells - 1) // 2
        return self.descriptor_channels * n

    @property
    def descriptor_bytes(self) -> int:
        return (self.descriptor_bits + 7) // 8

    @property
    def descriptor_words(self) -> int:
        """32-bit words holding the packed descriptor (16 for 486 bits)."""
        return (self.descriptor_bytes + 3) // 4


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Brute-force Hamming matcher options."""

    ratio: float = 0.8
    mutual: bool = True
    max_distance: int = 486
    # TPU-only knob, kept for 1:1 conversion; not read by the port.
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Fixed-iteration RANSAC for the essential matrix: `num_iterations`
    8-point hypotheses scored by Sampson distance (threshold in normalized
    image coordinates), then the guarded LO-RANSAC refit of the top
    `refit_beam` hypotheses."""

    num_iterations: int = 512
    sample_size: int = 8  # 8-point algorithm
    inlier_threshold: float = 1e-3
    seed: int = 0
    refit_beam: int = 32


@dataclasses.dataclass(frozen=True)
class SfmConfig:
    """Incremental SfM / bundle adjustment options, every field read by the
    port: the LM bundle adjustment (`ba_iterations`, `ba_obs_per_point`,
    `lm_lambda_init`, `lm_lambda_max`, `huber_delta`; `sfm/ba.py`,
    `sfm/incremental.py`), the video front end's keyframe rule
    (`keyframe_min_tracked`) and the pose-graph edge weights
    (`pgo_odometry_sigma`, `pgo_closure_sigma`)."""

    ba_iterations: int = 10
    ba_obs_per_point: int = 8
    lm_lambda_init: float = 1e-3
    lm_lambda_max: float = 1e6
    huber_delta: float = 3.0
    # A new keyframe is inserted when the matches to the last keyframe fall
    # below this fraction of the keyframe's reference count.
    keyframe_min_tracked: float = 0.6
    pgo_odometry_sigma: float = 5e-5
    pgo_closure_sigma: float = 2e-3


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Rank layout of the parallel paths (`akaze_tpu_torch/parallel/`)."""

    data: int = 1  # frames / point blocks sharded along this axis
    spatial: int = 1  # image rows sharded along this axis (FED halo exchange)

    @property
    def num_devices(self) -> int:
        return self.data * self.spatial
