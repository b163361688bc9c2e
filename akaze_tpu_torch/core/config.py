"""Configuration dataclasses of the PyTorch port (own copy of the JAX
package's `akaze_tpu/core/config.py`, same fields and defaults).

The TPU execution knobs (`pallas_octaves`, `patch_backend`,
`describe_backend`, `describe_group`, `describe_loop`, `deep_octave_frames`,
`MatchConfig.backend`) are kept as fields so that a configuration converts
field for field between the two packages; the port reads none of them, and
it reads no environment variable.
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
