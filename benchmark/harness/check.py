"""The comparison that decides `correct`: the program's outputs from the
timed window against the plain reference's on the same inputs.

Each number is the worst over the sampled frames, pairs or poses:
- keypoints_off: share of the keypoint slots of one octave of a frame
  (valid on either side) where the two differ: validity, level, x or y by
  more than 1e-3 px, response by more than 1e-4 of itself, or angle by
  more than 1e-3 rad; the worst octave counts, so a fault confined to the
  coarse octaves, which hold a few per cent of a frame's keypoints, reads
  as high as one that moves every keypoint;
- descriptor_bits_off: share of a frame's descriptor bits that differ,
  over the reference's keypoints that have a keypoint of the program on
  the same level within PAIR_RADIUS px (the nearest one);
- matches_off: share of a pair's rows accepted on either side whose
  acceptance or matched index differs;
- rotation_gap_deg, translation_gap_deg: angle between the two rotations,
  between the two unit translations; inliers_off: inlier counts' gap over
  the reference's count.
The tolerances inside a slot's agreement sit far below a pixel and far
above float32 rounding, so a reordered sum does not count and a moved
keypoint does.
"""

from __future__ import annotations

import math

import torch

XY_TOL, RESPONSE_RTOL, ANGLE_TOL = 1e-3, 1e-4, 1e-3
PAIR_RADIUS = 0.5
DESCRIPTOR_BITS = 486
FIELDS = ("x", "y", "response", "size", "octave", "class_id", "angle", "valid")
_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def features_of(feats) -> dict:
    """A program's `Features` as a dict of its (..., M) fields and
    "descriptors"."""
    kp = feats.keypoints
    out = {f: getattr(kp, f) for f in FIELDS}
    out["descriptors"] = feats.descriptors
    return out


def matches_of(m) -> dict:
    return {"idx_b": m.idx_b, "accepted": m.accepted}


def _popcount(words: torch.Tensor) -> torch.Tensor:
    return _POPCOUNT.to(words.device)[words.contiguous().view(torch.uint8).long()].sum(-1)


def features_off(got: dict, ref: dict, chunk: int = 16):
    """Per frame (keypoints_off, descriptor_bits_off) of (B, M) features;
    keypoints_off is the worst of the frame's octaves."""
    dev = ref["x"].device
    g = {k: v.to(dev) for k, v in got.items()}
    either = g["valid"] | ref["valid"]
    dang = torch.remainder(g["angle"] - ref["angle"] + math.pi, 2 * math.pi) - math.pi
    same = g["valid"] & ref["valid"] & (g["class_id"] == ref["class_id"]) \
        & ((g["x"] - ref["x"]).abs() <= XY_TOL) & ((g["y"] - ref["y"]).abs() <= XY_TOL) \
        & ((g["response"] - ref["response"]).abs() <= RESPONSE_RTOL * ref["response"].abs()) \
        & (dang.abs() <= ANGLE_TOL)
    octave = torch.where(ref["valid"], ref["octave"], g["octave"]).long()
    octave = torch.where(either, octave, 0).clamp(min=0)
    n_oct = int(octave.max()) + 1 if octave.numel() else 1
    off = torch.zeros((octave.shape[0], n_oct), dtype=torch.float64, device=dev)
    den = torch.zeros_like(off)
    off.scatter_add_(1, octave, (either & ~same).double())
    den.scatter_add_(1, octave, either.double())
    kp_off = (off / den.clamp(min=1)).amax(-1)
    desc_off = []
    for b0 in range(0, ref["x"].shape[0], chunk):
        r = {k: v[b0 : b0 + chunk] for k, v in ref.items()}
        q = {k: v[b0 : b0 + chunk] for k, v in g.items()}
        d2 = (r["x"][:, :, None] - q["x"][:, None, :]) ** 2 + (r["y"][:, :, None] - q["y"][:, None, :]) ** 2
        ok = r["valid"][:, :, None] & q["valid"][:, None, :] & (r["class_id"][:, :, None] == q["class_id"][:, None, :])
        dmin, j = torch.where(ok, d2, torch.full_like(d2, math.inf)).min(-1)
        paired = dmin <= PAIR_RADIUS**2
        words = torch.gather(q["descriptors"], 1, j[..., None].expand(-1, -1, q["descriptors"].shape[-1]))
        bits = torch.where(paired, _popcount(r["descriptors"] ^ words), 0).sum(-1).double()
        desc_off.append(bits / (DESCRIPTOR_BITS * paired.sum(-1).clamp(min=1).double()))
    return kp_off.cpu().tolist(), torch.cat(desc_off).cpu().tolist()


def matches_off(got: dict, ref: dict) -> list:
    """Per pair: share of the rows accepted on either side that differ."""
    dev = ref["idx_b"].device
    ga, gi = got["accepted"].to(dev), got["idx_b"].to(dev)
    either = ga | ref["accepted"]
    off = either & ((ga != ref["accepted"]) | (gi != ref["idx_b"]))
    return (off.sum(-1).double() / either.sum(-1).clamp(min=1).double()).cpu().tolist()


def _gap_deg(a: torch.Tensor, b: torch.Tensor, scale: float) -> list:
    """2 asin(|a - b| / scale) in degrees per leading index; inf where one
    side is not finite and the other is."""
    a, b = a.double().cpu(), b.double().cpu()
    out = []
    for x, y in zip(a, b):
        fx, fy = bool(torch.isfinite(x).all()), bool(torch.isfinite(y).all())
        if not (fx and fy):
            out.append(0.0 if fx == fy else math.inf)
            continue
        out.append(math.degrees(2 * math.asin(min(1.0, float(torch.linalg.norm(x - y)) / scale))))
    return out


def poses_off(got: dict, ref: dict) -> dict:
    """Per pair rotation and translation gaps (degrees) and the inlier
    counts' gap over the reference's."""
    n_got, n_ref = got["num_inliers"].cpu().double(), ref["num_inliers"].cpu().double()
    return {
        "rotation_gap_deg": _gap_deg(got["R"], ref["R"], 2 * math.sqrt(2)),
        "translation_gap_deg": _gap_deg(got["t"], ref["t"], 2.0),
        "inliers_off": ((n_got - n_ref).abs() / n_ref.clamp(min=1)).tolist(),
    }


def worst(per_item: dict) -> dict:
    return {name: max(values) if values else 0.0 for name, values in per_item.items()}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number within its limit."""
    rows = [(name, float(numbers[name]), float(limits[name])) for name in limits]
    return all(v <= lim for _, v, lim in rows), rows
