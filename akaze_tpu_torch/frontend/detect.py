"""Scale-space extrema detection on the per-octave detect fields
(counterpart of the JAX package's `akaze_tpu/frontend/detect.py`).

Candidates are the exact per-level top-K of the candidate scores
(`kernels/topk.py`: one CUDA launch on the card); a symmetric cross-level
NMS suppresses a candidate P when some candidate Q on the same or an
adjacent level lies within r = 0.5 * size[max(level_P, level_Q)] and beats
P on (response, earlier level-major raster order) (`kernels/nms.py`: one
CUDA launch on the card); the global top-M of the survivors is refined
from the packed sub-pixel field.
`detect_dense` is the same selection on the padded (L, H0, W0) Ldet stacks
of the per-level build (the JAX package's `detect` with cand=None): strict
3x3 maxima above threshold inside each level's border, exact top-K per
padded level plane, and the quadratic sub-pixel fit on Ldet itself.

Every top-K here is exact and breaks ties by the lower index first, as
`lax.top_k` does: each selection runs `kernels/topk.topk_padded`
(`torch.topk` on unique int64 keys: order-preserving score bits, then the
reversed index), or, for the per-level candidates on the card, the kernel
on the same order, so the CPU and the card pick the same slots.
"""

from __future__ import annotations

import torch

from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics
from akaze_tpu_torch.kernels.fed import NEG, unpack_sub
from akaze_tpu_torch.kernels.nms import cross_level_nms
from akaze_tpu_torch.kernels.topk import per_level_topk, topk_padded


def find_candidates_oct(oct_fields, statics: ScaleSpaceStatics) -> dict:
    """Per-level top-K candidates from per-octave level-major (n, B, h, w)
    score fields.  Returns (B, L, K) "resp", "yi", "xi" (level pixels),
    "flat" (index into the octave-0-sized plane) and "valid"."""
    return per_level_topk([prod["score"] for prod in oct_fields], statics)


def subpixel_from_fields_oct(lvl, xi, yi, oct_fields, statics: ScaleSpaceStatics):
    """Octave-0 (x, y) and the fit's keep flag for selected keypoints
    (B, M) from the per-octave packed sub-pixel fields (n, B, h, w)."""
    B = lvl.shape[0]
    frame = torch.arange(B, device=lvl.device)[:, None].expand_as(lvl)
    packed = torch.full_like(lvl, -1)
    for (l0, n, h, w), prod in zip(statics.groups, oct_fields):
        sel = (lvl >= l0) & (lvl < l0 + n)
        li = torch.clamp(lvl - l0, 0, n - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        packed = torch.where(sel, prod["sub"][li, frame, yc, xc], packed)
    ox, oy, keep = unpack_sub(packed)
    zero = torch.zeros_like(ox)
    ox = torch.where(keep, ox, zero)
    oy = torch.where(keep, oy, zero)
    ratios = statics.on(lvl.device).ratios[lvl.long()]
    xf = (xi.to(torch.float32) + ox) * ratios
    yf = (yi.to(torch.float32) + oy) * ratios
    return xf, yf, keep


def _neighbor_max_3x3(ldet: torch.Tensor) -> torch.Tensor:
    """Max over the 8 spatial neighbours of each pixel of (..., h, w)
    planes, the plane padded with the -3e38 sentinel (no edge replication)."""
    p = torch.nn.functional.pad(ldet, (1, 1, 1, 1), value=NEG)
    h, w = ldet.shape[-2], ldet.shape[-1]
    out = None
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            s = p[..., dy : dy + h, dx : dx + w]
            out = s if out is None else torch.maximum(out, s)
    return out


def find_candidates(ldet: torch.Tensor, statics: ScaleSpaceStatics) -> dict:
    """Per-level exact top-K of the strict 3x3 maxima above threshold and
    inside the level border, over padded (B, L, H0, W0) Ldet stacks.
    Returns (B, L, K) "resp", "yi", "xi", "flat" (index into the padded
    plane) and "valid"."""
    cfg = statics.config
    K = cfg.per_level_candidates
    B, L, h0, w0 = ldet.shape
    cand = (ldet > cfg.detector_threshold) & (ldet > _neighbor_max_3x3(ldet)) & statics.on(ldet.device).interior
    scores = torch.where(cand, ldet, torch.full_like(ldet, NEG)).reshape(B * L, h0 * w0)
    resp, idx = topk_padded(scores, K)
    resp, idx = resp.reshape(B, L, K), idx.reshape(B, L, K).to(torch.int32)
    yi = torch.div(idx, w0, rounding_mode="floor")
    return {"resp": resp, "yi": yi, "xi": idx - yi * w0, "flat": idx, "valid": resp > NEG}


def _top_m(cand: dict, statics: ScaleSpaceStatics):
    """NMS, then the global top-M of the survivors: (response, level, yi,
    xi), each (B, M), invalid slots at the -3e38 response."""
    cfg = statics.config
    masked = cross_level_nms(cand, statics)  # refuses an int32 overflow of the packed key below
    B, L, K = masked.shape
    flat_resp = masked.reshape(B, L * K)
    top_resp, order = topk_padded(flat_resp, cfg.max_keypoints)
    npx = statics.h0 * statics.w0
    w0 = statics.w0
    lvl = torch.arange(L, dtype=torch.int32, device=flat_resp.device)[:, None].expand(L, K)
    packed = (lvl * npx + cand["flat"]).reshape(B, L * K)
    sel = torch.gather(packed, 1, order)
    class_id = torch.div(sel, npx, rounding_mode="floor")
    rem = sel - class_id * npx
    yi = torch.div(rem, w0, rounding_mode="floor")
    return top_resp, class_id, yi, rem - yi * w0


def _keypoints(top_resp, class_id, xf, yf, keep, statics: ScaleSpaceStatics) -> Keypoints:
    tables = statics.on(class_id.device)
    cls = class_id.long()
    return Keypoints(
        x=xf,
        y=yf,
        response=top_resp,
        size=tables.sizes[cls],
        octave=tables.octaves[cls],
        class_id=class_id,
        angle=torch.zeros_like(xf),
        valid=(top_resp > NEG) & keep,
    )


def detect(cand: dict, oct_fields, statics: ScaleSpaceStatics) -> Keypoints:
    """Candidates -> NMS -> global top-M -> sub-pixel from the per-octave
    packed fields; (B, M) keypoints."""
    top_resp, class_id, yi, xi = _top_m(cand, statics)
    xf, yf, keep = subpixel_from_fields_oct(class_id, xi, yi, oct_fields, statics)
    return _keypoints(top_resp, class_id, xf, yf, keep, statics)


def subpixel_refine(lvl, yi, xi, ldet: torch.Tensor, statics: ScaleSpaceStatics):
    """2-variable quadratic fit on padded (B, L, H0, W0) Ldet at selected
    (B, M) keypoints; a fit with |offset| > 1 is rejected.  Returns
    octave-0 (x, y) and the keep flag.  Indices read as JAX reads them
    (a negative index counts from the end, then clamps); only invalid slots
    ever reach past a level's border."""
    B, L, h0, w0 = ldet.shape
    frame = torch.arange(B, device=ldet.device)[:, None].expand_as(lvl)
    flat = ldet.reshape(-1)

    def index(i, n):
        i = i.long()
        return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)

    li = index(lvl, L)

    def at(dy, dx):
        return flat[((frame * L + li) * h0 + index(yi + dy, h0)) * w0 + index(xi + dx, w0)]

    v = at(0, 0)
    dxv = 0.5 * (at(0, 1) - at(0, -1))
    dyv = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = at(0, 1) + at(0, -1) - 2.0 * v
    dyy = at(1, 0) + at(-1, 0) - 2.0 * v
    dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(-1, 1) - at(1, -1))
    det = dxx * dyy - dxy * dxy
    tiny = torch.abs(det) < 1e-30
    safe_det = torch.where(tiny, torch.ones_like(det), det)
    ox = (-dxv * dyy + dyv * dxy) / safe_det
    oy = (-dyv * dxx + dxv * dxy) / safe_det
    keep = ~tiny & (torch.abs(ox) <= 1.0) & (torch.abs(oy) <= 1.0)
    ratios = statics.on(ldet.device).ratios[li]
    xf = (xi.to(torch.float32) + ox) * ratios
    yf = (yi.to(torch.float32) + oy) * ratios
    return xf, yf, keep


def detect_dense(ldet: torch.Tensor, statics: ScaleSpaceStatics) -> Keypoints:
    """Detection on padded (B, L, H0, W0) Ldet stacks: candidates -> NMS ->
    global top-M -> sub-pixel fit on Ldet; (B, M) keypoints."""
    top_resp, class_id, yi, xi = _top_m(find_candidates(ldet, statics), statics)
    xf, yf, keep = subpixel_refine(class_id, yi, xi, ldet, statics)
    return _keypoints(top_resp, class_id, xf, yf, keep, statics)
