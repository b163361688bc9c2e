"""Scale-space extrema detection on the per-octave detect fields
(counterpart of the JAX package's `akaze_tpu/frontend/detect.py`).

Candidates are the exact per-level top-K of the candidate scores; a
symmetric cross-level NMS suppresses a candidate P when some candidate Q on
the same or an adjacent level lies within r = 0.5 * size[max(level_P,
level_Q)] and beats P on (response, earlier level-major raster order); the
global top-M of the survivors is refined from the packed sub-pixel field.

Every top-K here is exact and breaks ties by the lower index first, as
`lax.top_k` does: each selection runs `torch.topk` on unique int64 keys
(order-preserving score bits, then the reversed index), so the CPU and the
card pick the same slots.
"""

from __future__ import annotations

import torch

from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics
from akaze_tpu_torch.kernels.fed import NEG, octave_groups, unpack_sub


def _topk_stable(values: torch.Tensor, k: int):
    """Top-k along the last axis of float32 `values`, ties to the lower
    index, as (values, indices) sorted best first."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)  # float order as int order
    n = values.shape[-1]
    index = torch.arange(n, device=values.device, dtype=torch.int64)
    key = ordered * (1 << 32) + (n - 1 - index)
    idx = torch.topk(key, k, dim=-1, sorted=True).indices
    return torch.gather(values, -1, idx), idx


def find_candidates_oct(oct_fields, statics: ScaleSpaceStatics) -> dict:
    """Per-level top-K candidates from per-octave level-major (n, B, h, w)
    score fields.  Returns (B, L, K) "resp", "yi", "xi" (level pixels),
    "flat" (index into the octave-0-sized plane) and "valid"."""
    K = statics.config.per_level_candidates
    w0 = statics.w0
    resp_g, yi_g, xi_g = [], [], []
    for (_, n, h, w), prod in zip(octave_groups(statics), oct_fields):
        score = prod["score"]
        B = score.shape[1]
        flat = score.reshape(n * B, h * w)
        k = min(K, h * w)
        resp, idx = _topk_stable(flat, k)
        if k < K:
            resp = torch.nn.functional.pad(resp, (0, K - k), value=NEG)
            idx = torch.nn.functional.pad(idx, (0, K - k))
        resp_g.append(resp.reshape(n, B, K).transpose(0, 1))
        yi_g.append(torch.div(idx, w, rounding_mode="floor").reshape(n, B, K).transpose(0, 1))
        xi_g.append((idx % w).reshape(n, B, K).transpose(0, 1))
    resp = torch.cat(resp_g, dim=1)
    yi = torch.cat(yi_g, dim=1).to(torch.int32)
    xi = torch.cat(xi_g, dim=1).to(torch.int32)
    return {"resp": resp, "yi": yi, "xi": xi, "flat": yi * w0 + xi, "valid": resp > NEG}


def cross_level_nms(cand: dict, statics: ScaleSpaceStatics) -> torch.Tensor:
    """Symmetric NMS over same + adjacent levels on (B, L, K) candidates;
    returns the surviving mask."""
    dev = cand["resp"].device
    L = statics.num_levels
    ratios = torch.as_tensor(statics.ratios, device=dev)[:, None]
    x0 = cand["xi"].to(torch.float32) * ratios
    y0 = cand["yi"].to(torch.float32) * ratios
    resp = cand["resp"]
    valid = cand["valid"]
    npx = statics.h0 * statics.w0
    tie = torch.arange(L, dtype=torch.int32, device=dev)[:, None] * npx + cand["flat"]
    r2 = torch.as_tensor((statics.config.dedup_radius_factor * statics.sizes) ** 2, device=dev)
    r2_next = torch.cat([r2[1:], torch.zeros_like(r2[:1])])

    def shift(a, d, fill):
        """Shift along the level axis by d (d = +1: level l sees l-1)."""
        pad = torch.full_like(a[:, :1], fill)
        if d == 1:
            return torch.cat([pad, a[:, :-1]], dim=1)
        return torch.cat([a[:, 1:], pad], dim=1)

    suppressed = torch.zeros_like(valid)
    for d, r2_pair in ((0, r2), (1, r2), (-1, r2_next)):
        if d == 0:
            qx, qy, qresp, qtie, qvalid = x0, y0, resp, tie, valid
        else:
            qx, qy = shift(x0, d, 0.0), shift(y0, d, 0.0)
            qresp, qtie, qvalid = shift(resp, d, NEG), shift(tie, d, 0), shift(valid, d, False)
        dx = x0[..., :, None] - qx[..., None, :]
        dy = y0[..., :, None] - qy[..., None, :]
        close = dx * dx + dy * dy <= r2_pair[:, None, None]
        beats = (qresp[..., None, :] > resp[..., :, None]) | (
            (qresp[..., None, :] == resp[..., :, None]) & (qtie[..., None, :] < tie[..., :, None])
        )
        suppressed |= (close & beats & qvalid[..., None, :]).any(dim=-1)
    return valid & ~suppressed


def subpixel_from_fields_oct(lvl, xi, yi, oct_fields, statics: ScaleSpaceStatics):
    """Octave-0 (x, y) and the fit's keep flag for selected keypoints
    (B, M) from the per-octave packed sub-pixel fields (n, B, h, w)."""
    B = lvl.shape[0]
    frame = torch.arange(B, device=lvl.device)[:, None].expand_as(lvl)
    packed = torch.full_like(lvl, -1)
    for (l0, n, h, w), prod in zip(octave_groups(statics), oct_fields):
        sel = (lvl >= l0) & (lvl < l0 + n)
        li = torch.clamp(lvl - l0, 0, n - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        packed = torch.where(sel, prod["sub"][li, frame, yc, xc], packed)
    ox, oy, keep = unpack_sub(packed)
    zero = torch.zeros_like(ox)
    ox = torch.where(keep, ox, zero)
    oy = torch.where(keep, oy, zero)
    ratios = torch.as_tensor(statics.ratios, device=lvl.device)[lvl.long()]
    xf = (xi.to(torch.float32) + ox) * ratios
    yf = (yi.to(torch.float32) + oy) * ratios
    return xf, yf, keep


def detect(cand: dict, oct_fields, statics: ScaleSpaceStatics) -> Keypoints:
    """Candidates -> NMS -> global top-M -> sub-pixel; (B, M) keypoints."""
    cfg = statics.config
    valid = cross_level_nms(cand, statics)
    B, L, K = valid.shape
    flat_resp = torch.where(valid, cand["resp"], torch.full_like(cand["resp"], NEG)).reshape(B, L * K)
    M = cfg.max_keypoints
    k = min(M, L * K)
    top_resp, order = _topk_stable(flat_resp, k)
    if k < M:
        top_resp = torch.nn.functional.pad(top_resp, (0, M - k), value=NEG)
        order = torch.nn.functional.pad(order, (0, M - k))
    npx = statics.h0 * statics.w0
    if npx * L >= 2**31:
        raise ValueError(f"packed candidate key overflows int32: {npx} px * {L} levels")
    w0 = statics.w0
    lvl = torch.arange(L, dtype=torch.int32, device=valid.device)[:, None].expand(L, K)
    packed = (lvl * npx + cand["flat"]).reshape(B, L * K)
    sel = torch.gather(packed, 1, order)
    class_id = torch.div(sel, npx, rounding_mode="floor")
    rem = sel - class_id * npx
    yi = torch.div(rem, w0, rounding_mode="floor")
    xi = rem - yi * w0
    xf, yf, keep = subpixel_from_fields_oct(class_id, xi, yi, oct_fields, statics)
    dev = valid.device
    cls = class_id.long()
    return Keypoints(
        x=xf,
        y=yf,
        response=top_resp,
        size=torch.as_tensor(statics.sizes, device=dev)[cls],
        octave=torch.as_tensor(statics.octaves, device=dev)[cls],
        class_id=class_id,
        angle=torch.zeros_like(xf),
        valid=(top_resp > NEG) & keep,
    )
