"""State that crosses between the JAX package and the port.

The system has no learned weights: what crosses is the configuration and
the extracted `Features`.  Both directions go through plain dicts and numpy
arrays, so this module imports nothing of the JAX package:

    cfg = config_from_fields(dataclasses.asdict(jax_config))
    feats = features_from_numpy(arrays, device="cuda")
    arrays = features_to_numpy(feats)   # descriptors as a uint32 view
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.core.types import Features, Keypoints

_KEYPOINT_FIELDS = tuple(f.name for f in dataclasses.fields(Keypoints))
_KEYPOINT_DTYPES = {
    "x": np.float32, "y": np.float32, "response": np.float32, "size": np.float32,
    "octave": np.int32, "class_id": np.int32, "angle": np.float32, "valid": np.bool_,
}


def config_from_fields(fields: dict):
    """An AkazeConfig or MatchConfig from the fields of either package's
    config (e.g. `dataclasses.asdict`).  The diffusivity may be an enum
    member of either package or its string value."""
    match_names = {f.name for f in dataclasses.fields(MatchConfig)}
    if set(fields) <= match_names:
        return MatchConfig(**fields)
    fields = dict(fields)
    if "diffusivity" in fields:
        d = fields["diffusivity"]
        fields["diffusivity"] = Diffusivity(getattr(d, "value", d))
    return AkazeConfig(**fields)


def features_to_numpy(feats: Features) -> dict:
    """Keypoint fields plus "descriptors" (uint32 words) as numpy arrays."""
    out = {name: getattr(feats.keypoints, name).cpu().numpy() for name in _KEYPOINT_FIELDS}
    out["descriptors"] = feats.descriptors.cpu().numpy().view(np.uint32)
    return out


def features_from_numpy(arrays: dict, device="cuda") -> Features:
    """Features on `device` (the card unless the caller asks for the CPU)
    from numpy keypoint fields and uint32 (or int32) descriptor words."""
    device = resolve_device(device)
    kp = {
        name: torch.from_numpy(np.array(arrays[name], _KEYPOINT_DTYPES[name])).to(device)
        for name in _KEYPOINT_FIELDS
    }
    desc = np.array(arrays["descriptors"]).view(np.int32)
    return Features(keypoints=Keypoints(**kp), descriptors=torch.from_numpy(desc).to(device))
