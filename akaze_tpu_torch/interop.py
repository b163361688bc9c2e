"""State that crosses between the JAX package and the port.

The system has no learned weights: what crosses is the configuration, the
extracted `Features` and the SfM state (a bundle-adjustment problem, a map
checkpoint, loop closures).  Both directions go through plain dicts and
numpy arrays, so this module imports nothing of the JAX package:

    cfg = config_from_fields(dataclasses.asdict(jax_config))  # any of the five configs
    feats = features_from_numpy(arrays, device="cuda")
    arrays = features_to_numpy(feats)   # descriptors as a uint32 view
    problem = ba_problem_from_numpy({f: np.asarray(getattr(jax_problem, f)) for f in BA_FIELDS})
    ckpt = checkpoint_from_fields(dataclasses.asdict(jax_checkpoint))
    closures = closures_from_fields([dataclasses.asdict(c) for c in jax_closures])
    # and back: jax_sfm.SfmCheckpoint(**dataclasses.asdict(ckpt)), jax_sfm.Closure(**dataclasses.asdict(c))
    scores = jax_uniform(0, (512, 1024))  # = jax.random.uniform(PRNGKey(0), ...)
    scores = jax_uniform(0, (64, 128), fold_in=7)  # ... (fold_in(PRNGKey(0), 7), ...)
    shards = ba_problem_shards(problem, 2)  # the point blocks of bundle_adjust_sharded
    gold = golden_to_numpy(golden.akaze.extract(img))  # the oracles' outputs under
    nat = native_to_numpy(*native.extract_native(img))  # features_to_numpy's keys

`jax_uniform` lets a machine without JAX feed the port the very random
scores of a JAX experiment (`estimate_relative_pose_fn(..., sample_scores=)`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig, MeshConfig, RansacConfig, SfmConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.core.types import Features, Keypoints
from akaze_tpu_torch.sfm.ba import POINT_FIELDS, BAProblem
from akaze_tpu_torch.sfm.checkpoint import SfmCheckpoint
from akaze_tpu_torch.sfm.loop_closure import Closure

_KEYPOINT_FIELDS = tuple(f.name for f in dataclasses.fields(Keypoints))
_KEYPOINT_DTYPES = {
    "x": np.float32, "y": np.float32, "response": np.float32, "size": np.float32,
    "octave": np.int32, "class_id": np.int32, "angle": np.float32, "valid": np.bool_,
}


def config_from_fields(fields: dict):
    """An AkazeConfig, MatchConfig, RansacConfig, SfmConfig or MeshConfig
    from the fields of either package's config (e.g. `dataclasses.asdict`),
    told apart by their field names (no two of the five share one).  The
    diffusivity may be an enum member of either package or its string
    value."""
    for cls in (MatchConfig, RansacConfig, SfmConfig, MeshConfig):
        if set(fields) <= {f.name for f in dataclasses.fields(cls)}:
            return cls(**fields)
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


def pack_descriptor_bytes(desc: np.ndarray, words: int = 16) -> np.ndarray:
    """(N, 61) uint8 descriptors -> (N, words) little-endian uint32 words,
    the layout of the card's descriptors (bits past the 486th are 0)."""
    desc = np.asarray(desc, np.uint8)
    padded = np.zeros((desc.shape[0], 4 * words), np.uint8)
    padded[:, : desc.shape[1]] = desc
    return padded.view("<u4")


def golden_to_numpy(result) -> dict:
    """The golden NumPy model's `extract` result as `features_to_numpy`
    arrays: one valid slot per keypoint, in the oracle's order."""
    kps = result.keypoints
    out = {name: np.array([getattr(k, name) for k in kps], _KEYPOINT_DTYPES[name])
           for name in _KEYPOINT_FIELDS if name != "valid"}
    out["valid"] = np.ones(len(kps), np.bool_)
    out["descriptors"] = pack_descriptor_bytes(result.descriptors.reshape(len(kps), -1))
    return out


def native_to_numpy(kps: np.ndarray, desc: np.ndarray) -> dict:
    """`native.extract_native`'s (N, 7) keypoint rows (x, y, response, size,
    octave, class_id, angle) and (N, 61) descriptor bytes as
    `features_to_numpy` arrays."""
    kps = np.asarray(kps, np.float32).reshape(-1, 7)
    cols = ("x", "y", "response", "size", "octave", "class_id", "angle")
    out = {name: kps[:, i].astype(_KEYPOINT_DTYPES[name]) for i, name in enumerate(cols)}
    out["valid"] = np.ones(len(kps), np.bool_)
    out["descriptors"] = pack_descriptor_bytes(desc)
    return out


#: The fields of a bundle-adjustment problem, in both packages.
BA_FIELDS = tuple(f.name for f in dataclasses.fields(BAProblem))
_BA_DTYPES = {"poses": np.float32, "points": np.float32, "obs_cam": np.int64, "obs_uv": np.float32,
              "obs_valid": np.bool_, "fixed": np.bool_}


def ba_problem_from_numpy(arrays: dict, device="cuda") -> BAProblem:
    """A `BAProblem` on `device` (the card unless the caller asks for the
    CPU) from numpy arrays of its six fields (e.g. a JAX problem's)."""
    device = resolve_device(device)
    return BAProblem(**{f: torch.from_numpy(np.array(arrays[f], _BA_DTYPES[f])).to(device) for f in BA_FIELDS})


def ba_problem_to_numpy(problem: BAProblem) -> dict:
    """The six fields of a problem as numpy arrays (obs_cam as int32, the
    JAX package's dtype)."""
    out = {f: getattr(problem, f).cpu().numpy() for f in BA_FIELDS}
    out["obs_cam"] = out["obs_cam"].astype(np.int32)
    return out


def ba_problem_shards(problem: BAProblem, n: int) -> list:
    """`problem` cut into n contiguous blocks of its points and observation
    rows, each with the whole problem's poses and fixed flags: shard r is
    what rank r of an n-rank `bundle_adjust_sharded` takes.  The point count
    must be a multiple of n."""
    P = problem.points.shape[0]
    if P % n:
        raise ValueError(f"{P} points are not divisible into {n} shards")
    per = P // n
    return [problem.rows(slice(r * per, (r + 1) * per)) for r in range(n)]


def ba_problem_from_shards(shards) -> BAProblem:
    """The whole problem from its shards (`ba_problem_shards`' inverse):
    points and observation rows concatenated in order, the poses and fixed
    flags of the first shard."""
    return shards[0].replace(**{f: torch.cat([getattr(s, f) for s in shards]) for f in POINT_FIELDS})


def checkpoint_from_fields(fields: dict) -> SfmCheckpoint:
    """The port's `SfmCheckpoint` from the fields of either package's (e.g.
    `dataclasses.asdict`); the same file format serves both, and
    `dataclasses.asdict` of the port's builds either package's."""
    return SfmCheckpoint(
        poses=np.array(fields["poses"], np.float32), points=np.array(fields["points"], np.float32),
        track_point={int(k): int(v) for k, v in fields["track_point"].items()},
        keyframe_frames=[int(x) for x in fields["keyframe_frames"]], next_keyframe=int(fields["next_keyframe"]),
    )


def closures_from_fields(items) -> list:
    """The port's `Closure`s from the fields of either package's
    (`dataclasses.asdict` of the port's builds either package's)."""
    return [Closure(i=int(c["i"]), j=int(c["j"]), matches=np.array(c["matches"], np.int64).reshape(-1, 2),
                    rel6=np.array(c["rel6"], np.float32), num_inliers=int(c["num_inliers"])) for c in items]


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 arrays."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def jax_uniform(seed: int, shape, fold_in: int | None = None) -> np.ndarray:
    """float32 numpy array equal to `jax.random.uniform(jax.random.PRNGKey(seed),
    shape)` under JAX's default generator (threefry2x32, partitionable
    counters), or with `fold_in` to `jax.random.uniform(jax.random.fold_in(
    jax.random.PRNGKey(seed), fold_in), shape)` (the pipeline's per-frame
    keys).  PRNGKey(seed) is the word pair (0, seed); fold_in(key, d) is
    Threefry(key, (0, d)); element i is Threefry(key, (i >> 32, i &
    0xffffffff)), the two output words xored, its top 23 bits as the
    mantissa of a float in [1, 2), minus 1.  Seeds and folded values are
    0 <= x < 2**32 (JAX's 32-bit keys)."""
    for name, v in (("seed", seed), ("fold_in", fold_in)):
        if v is not None and not 0 <= v < 2**32:
            raise ValueError(f"jax_uniform takes 0 <= {name} < 2**32, got {v}")
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        key = (np.uint32(0), np.uint32(seed))
        if fold_in is not None:
            key = tuple(w[0] for w in _threefry2x32(*key, np.zeros(1, np.uint32), np.full(1, fold_in, np.uint32)))
        b1, b2 = _threefry2x32(*key, hi, lo)
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0)).reshape(shape)
