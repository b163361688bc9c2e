"""The system under test: the entry points of akaze_tpu_torch that the
timed windows drive, its configurations, and its CUDA-event spans.
Nothing else of the program is used by the benchmark."""

from __future__ import annotations

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig, RansacConfig
from akaze_tpu_torch.frontend.pipeline import extract, extract_batch
from akaze_tpu_torch.geometry.twoview import estimate_relative_pose, normalize_points
from akaze_tpu_torch.matching.hamming import match, match_features
from akaze_tpu_torch.utils.profiling import SpanRecorder, record_spans

__all__ = ["AkazeConfig", "MatchConfig", "RansacConfig", "extract", "extract_batch", "estimate_relative_pose",
           "normalize_points", "match", "match_features", "SpanRecorder", "record_spans", "configs"]


def configs(config: dict, mix: dict):
    """(AkazeConfig, MatchConfig, RansacConfig or None) of a configuration
    file and a traffic mix."""
    ak = dict(config["akaze"])
    ak["diffusivity"] = Diffusivity(ak["diffusivity"])
    ransac = RansacConfig(**mix["ransac"]) if "ransac" in mix else None
    return AkazeConfig(**ak), MatchConfig(**config["match"]), ransac
