"""The detector's symmetric cross-level NMS: one CUDA launch per call
(`csrc/nms.cu`) on CUDA tensors, its plain PyTorch form on CPU tensors.

The candidates are the (B, L, K) per-level top-K of `frontend/detect.py`:
"resp" float32, "xi", "yi" (level pixels) and "flat" int32, "valid" bool.
A candidate P is suppressed when some valid candidate Q on the same or an
adjacent level lies within r = dedup_radius_factor * size[max(level_P,
level_Q)] in octave-0 pixels and beats P on (response, then the lower
level-major raster key level * h0 * w0 + flat).  The wrapper returns the
survivors' responses, NEG elsewhere: the keys `frontend/detect.py` ranks,
from the kernel bit for bit what the plain form's mask gives through
`torch.where`.
"""

from __future__ import annotations

import ctypes

import torch

from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.fed import NEG

_FIELDS = (("resp", torch.float32), ("xi", torch.int32), ("yi", torch.int32), ("flat", torch.int32),
           ("valid", torch.bool))


def cross_level_nms_plain(cand: dict, statics) -> torch.Tensor:
    """Symmetric NMS over same + adjacent levels on (B, L, K) candidates;
    returns the surviving mask."""
    dev = cand["resp"].device
    L = statics.num_levels
    ratios, r2 = statics.on(dev).nms
    ratios = ratios[:, None]
    x0 = cand["xi"].to(torch.float32) * ratios
    y0 = cand["yi"].to(torch.float32) * ratios
    resp = cand["resp"]
    valid = cand["valid"]
    npx = statics.h0 * statics.w0
    tie = torch.arange(L, dtype=torch.int32, device=dev)[:, None] * npx + cand["flat"]
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


def _check(cand: dict, statics) -> None:
    resp = cand["resp"]
    if resp.ndim != 3 or resp.shape[1] != statics.num_levels:
        raise ValueError(f"cross_level_nms: candidates must be (B, {statics.num_levels}, K), "
                         f"got {tuple(resp.shape)}")
    for name, dtype in _FIELDS:
        t = cand[name]
        if t.dtype != dtype or t.shape != resp.shape or not t.is_contiguous():
            raise ValueError(f"cross_level_nms: {name} must be contiguous {dtype} {tuple(resp.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}{'' if t.is_contiguous() else ' (not contiguous)'}")
        if t.device != resp.device:
            raise ValueError(f"cross_level_nms: {name} is on {t.device}, resp on {resp.device}")


def cross_level_nms(cand: dict, statics) -> torch.Tensor:
    """(B, L, K) responses of the survivors, NEG elsewhere: one kernel
    launch on CUDA tensors, the plain form on CPU tensors."""
    if statics.h0 * statics.w0 * statics.num_levels >= 2**31:
        raise ValueError(f"cross_level_nms: the tie key level * h0 * w0 + flat overflows int32: "
                         f"{statics.h0 * statics.w0} px * {statics.num_levels} levels")
    resp = cand["resp"]
    if resp.device.type == "cpu":
        return torch.where(cross_level_nms_plain(cand, statics), resp, torch.full_like(resp, NEG))
    _build.require_cuda(resp, "cross_level_nms")
    _check(cand, statics)
    B, L, K = resp.shape
    masked = torch.empty_like(resp)
    if masked.numel() == 0:
        return masked
    tables = statics.on(resp.device).nms  # (2, L) float32: ratios, squared radii
    P_, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("nms", "cross_level_nms", [P_, P_, P_, P_, P_, P_, I, I, I, I, ctypes.c_float, P_, P_])
    with torch.cuda.device(resp.device):
        err = fn(resp.data_ptr(), cand["xi"].data_ptr(), cand["yi"].data_ptr(), cand["flat"].data_ptr(),
                 cand["valid"].data_ptr(), tables.data_ptr(), B, L, K, statics.h0 * statics.w0, NEG,
                 masked.data_ptr(), _build.stream_of(resp))
    _build.check("nms", err, "cross_level_nms")
    _build.launches["nms"] += 1
    return masked
