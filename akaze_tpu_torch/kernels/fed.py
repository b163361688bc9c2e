"""Kernels 1 (`base_stage`) and 2 (`fused_octave`) with their plain PyTorch
twins, the packed sub-pixel format and the batched scale-space builder
(counterpart of the JAX package's `akaze_tpu/kernels/fed_pallas.py`).

Each wrapper runs its plain twin for CPU tensors and launches its CUDA
kernel (`csrc/fed.cu`) for CUDA tensors; there is no fallback between the
two.  The builder's outputs keep the TPU layout: per octave, level-major
(n, B, h, w) stacks `Lt/Lx/Ly` and detect fields `score` (f32) / `sub`
(packed int32), and each octave hands the next its in-kernel half-size
seed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
from akaze_tpu_torch.core.image import gaussian_kernel, scharr_kernels
from akaze_tpu_torch.frontend.scale_space import (
    conductivity,
    contrast_factor_from_modg,
    detector_response_level,
    fed_cycle,
    gaussian_blur,
    half_size,
    scharr,
    shift,
)
from akaze_tpu_torch.kernels import _build

#: Sub-pixel offsets quantise to 1/16000 px in two 16-bit halves of one
#: int32 word; -1 marks a rejected fit.
SUB_SCALE = 16000.0
NEG = -3.0e38  # candidate-score sentinel
_DIFFUSIVITY_CODE = {Diffusivity.PM_G1: 0, Diffusivity.PM_G2: 1, Diffusivity.WEICKERT: 2}
_MAXTAPS = 9

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)


def pack_sub(ox: torch.Tensor, oy: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(ox, oy, keep) -> int32 qx * 65536 + qy (-1 = reject); rounds half
    to even like `jnp.round`."""
    zero = torch.zeros_like(ox)
    qx = torch.round((torch.clamp(torch.where(keep, ox, zero), -1.0, 1.0) + 1.0) * SUB_SCALE)
    qy = torch.round((torch.clamp(torch.where(keep, oy, zero), -1.0, 1.0) + 1.0) * SUB_SCALE)
    packed = qx.to(torch.int32) * 65536 + qy.to(torch.int32)
    return torch.where(keep, packed, torch.full_like(packed, -1))


def unpack_sub(packed: torch.Tensor):
    """int32 packed field values -> (ox, oy, keep)."""
    keep = packed >= 0
    p = torch.clamp(packed, min=0)
    qx = torch.div(p, 65536, rounding_mode="floor")
    qy = p - qx * 65536
    inv = float(np.float32(1.0 / SUB_SCALE))
    return qx.to(torch.float32) * inv - 1.0, qy.to(torch.float32) * inv - 1.0, keep


def octave_groups(statics) -> tuple:
    """Per-octave (first level, level count, h, w) of the level list."""
    groups = []
    lvl = 0
    L = statics.num_levels
    while lvl < L:
        h, w = int(statics.heights[lvl]), int(statics.widths[lvl])
        n = 1
        while lvl + n < L and int(statics.heights[lvl + n]) == h:
            n += 1
        groups.append((lvl, n, h, w))
        lvl += n
    return tuple(groups)


# ------------------------------------------------------------------ kernel 1


def base_stage_plain(imgs: torch.Tensor, sigma0: float):
    """(B, H, W) -> (seed = G_sigma0 * img, modg = |Scharr grad(G_1 * img)|)."""
    seed = gaussian_blur(imgs, sigma0)
    sm = gaussian_blur(imgs, 1.0)
    gx = scharr(sm, 1, 0, 1)
    gy = scharr(sm, 0, 1, 1)
    return seed, torch.sqrt(gx * gx + gy * gy)


def _check_planes(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32 or t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{what}: expects a contiguous float32 (B, H, W) tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


def base_stage(imgs: torch.Tensor, sigma0: float):
    """Kernel 1 on CUDA tensors, its plain twin on CPU tensors."""
    if imgs.device.type == "cpu":
        return base_stage_plain(imgs, sigma0)
    _build.require_cuda(imgs, "base_stage")
    _check_planes(imgs, "base_stage")
    g0 = gaussian_kernel(sigma0)
    g1 = gaussian_kernel(1.0)
    if len(g0) > _MAXTAPS:
        raise ValueError(f"base_stage: sigma0 = {sigma0} needs {len(g0)} taps, the kernel takes {_MAXTAPS}")
    _, s1 = scharr_kernels(1)
    B, H, W = imgs.shape
    seed = torch.empty_like(imgs)
    modg = torch.empty_like(imgs)
    fn = _build.function("fed", "base_stage", [_P, _P, _P, _I, _I, _I, _FP, _I, _FP, _I, _F, _F, _P])
    with torch.cuda.device(imgs.device):
        err = fn(imgs.data_ptr(), seed.data_ptr(), modg.data_ptr(), B, H, W,
                 (_F * len(g0))(*g0), len(g0), (_F * len(g1))(*g1), len(g1),
                 float(s1[0]), float(s1[1]), _build.stream_of(imgs))
    _build.check("fed", err, "base_stage")
    _build.launches["base_stage"] += 1
    return seed, modg


# ------------------------------------------------------------------ kernel 2


def score_fields_plain(ldet: torch.Tensor, border: int, threshold: float):
    """Strict 3x3-max candidate score and packed sub-pixel field of one
    level (..., h, w), neighbours edge-replicated."""
    h, w = ldet.shape[-2], ldet.shape[-1]
    n_e, n_w = shift(ldet, 1, -1), shift(ldet, -1, -1)
    n_s, n_n = shift(ldet, 1, -2), shift(ldet, -1, -2)
    n_se, n_nw = shift(n_s, 1, -1), shift(n_n, -1, -1)
    n_ne, n_sw = shift(n_n, 1, -1), shift(n_s, -1, -1)
    nmax = torch.maximum(n_e, n_w)
    nmax = torch.maximum(nmax, torch.maximum(n_s, n_n))
    nmax = torch.maximum(nmax, torch.maximum(n_se, n_nw))
    nmax = torch.maximum(nmax, torch.maximum(n_ne, n_sw))
    ys = torch.arange(h, device=ldet.device)[:, None]
    xs = torch.arange(w, device=ldet.device)[None, :]
    interior = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    cand = interior & (ldet > threshold) & (ldet > nmax)
    score = torch.where(cand, ldet, torch.full_like(ldet, NEG))

    dxv = 0.5 * (n_e - n_w)
    dyv = 0.5 * (n_s - n_n)
    dxx = n_e + n_w - 2.0 * ldet
    dyy = n_s + n_n - 2.0 * ldet
    dxy = 0.25 * (n_se + n_nw - n_ne - n_sw)
    det = dxx * dyy - dxy * dxy
    tiny = torch.abs(det) < 1e-30
    safe_det = torch.where(tiny, torch.ones_like(det), det)
    ox = (-dxv * dyy + dyv * dxy) / safe_det
    oy = (-dyv * dxx + dxv * dxy) / safe_det
    keep = ~tiny & (torch.abs(ox) <= 1.0) & (torch.abs(oy) <= 1.0)
    return score, pack_sub(ox, oy, keep)


def fused_octave_plain(seed, k, specs, diffusivity: Diffusivity, first: bool,
                       threshold: float, with_half: bool):
    """One octave for a batch: seed (B, h, w), k (B,) -> level-major
    (n, B, h, w) Lt, Lx, Ly, score (f32), sub (int32), and the next
    octave's seed (B, h//2, w//2) or None."""
    kb = k.reshape(-1, 1, 1)
    x = seed
    lts, lxs, lys, scores, subs = [], [], [], [], []
    for li, spec in enumerate(specs):
        if first and li == 0:
            lsmooth = x
        else:
            lsmooth = gaussian_blur(x, 1.0)
            gx = scharr(lsmooth, 1, 0, 1)
            gy = scharr(lsmooth, 0, 1, 1)
            g = conductivity(gx, gy, kb, diffusivity)
            x = fed_cycle(x, g, spec.taus)
        lx, ly, ldet = detector_response_level(lsmooth, spec.sigma_size)
        score, sub = score_fields_plain(ldet, int(spec.border), threshold)
        lts.append(x)
        lxs.append(lx)
        lys.append(ly)
        scores.append(score)
        subs.append(sub)
    half = half_size(x) if with_half else None
    return (torch.stack(lts), torch.stack(lxs), torch.stack(lys), torch.stack(scores),
            torch.stack(subs), half)


def fused_octave(seed, k, specs, diffusivity: Diffusivity, first: bool,
                 threshold: float, with_half: bool):
    """Kernel 2 on CUDA tensors (one entry per octave, a fixed sequence of
    launches per level), its plain twin on CPU tensors."""
    if seed.device.type == "cpu":
        return fused_octave_plain(seed, k, specs, diffusivity, first, threshold, with_half)
    _build.require_cuda(seed, "fused_octave")
    _check_planes(seed, "fused_octave")
    if k.dtype != torch.float32 or k.shape != seed.shape[:1] or k.device != seed.device:
        raise ValueError("fused_octave: k must be a float32 (B,) tensor on the seed's device")
    k = k.contiguous()
    B, h, w = seed.shape
    n = len(specs)
    out = lambda dtype=torch.float32: torch.empty((n, B, h, w), dtype=dtype, device=seed.device)
    lt, lx, ly, score, sub = out(), out(), out(), out(), out(torch.int32)
    half = torch.empty((B, h // 2, w // 2), device=seed.device) if with_half else None
    scratch = [torch.empty_like(seed) for _ in range(6)]  # lsmooth, g, tmp, lxr, lyr, ldet

    n_sweeps = [len(s.taus) for s in specs]
    half_taus = [float(np.float32(0.5 * t)) for s in specs for t in s.taus]
    sn, swn = [], []
    for s in specs:
        _, smooth = scharr_kernels(s.sigma_size)
        sn.append(float(smooth[0]))
        swn.append(float(smooth[len(smooth) // 2]))
    g1 = gaussian_kernel(1.0)
    _, s1 = scharr_kernels(1)
    fn = _build.function("fed", "fused_octave", [
        _P, _P, _P, _P, _P, _P, _P, _P,  # seed, k, lt, lx, ly, score, sub, half
        _P, _P, _P, _P, _P, _P,  # scratch
        _I, _I, _I, _I, _I, _I,  # B, h, w, n, first, kind
        _IP, _FP, _IP, _FP, _FP, _IP, _F,  # per-level tables, threshold
        _FP, _I, _F, _F, _P,  # G_1 taps, sigma-1 Scharr taps, stream
    ])
    with torch.cuda.device(seed.device):
        err = fn(seed.data_ptr(), k.data_ptr(), lt.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                 score.data_ptr(), sub.data_ptr(), None if half is None else half.data_ptr(),
                 *(t.data_ptr() for t in scratch),
                 B, h, w, n, int(first), _DIFFUSIVITY_CODE[diffusivity],
                 (_I * n)(*n_sweeps), (_F * max(1, len(half_taus)))(*half_taus),
                 (_I * n)(*[s.sigma_size for s in specs]), (_F * n)(*sn), (_F * n)(*swn),
                 (_I * n)(*[s.border for s in specs]), float(threshold),
                 (_F * len(g1))(*g1), len(g1), float(s1[0]), float(s1[1]),
                 _build.stream_of(seed))
    _build.check("fed", err, "fused_octave")
    _build.launches["fused_octave"] += 1
    return lt, lx, ly, score, sub, half


# ------------------------------------------------------------------ builder


def build_scale_space(imgs: torch.Tensor, statics, plain: bool = False) -> dict:
    """Batched scale space with the fused detect fields.

    imgs (B, H, W) float32 -> {"lvl_oct": per octave {"Lt", "Lx", "Ly"}
    (n, B, h, w), "oct": per octave {"score", "sub"} (n, B, h, w)}.
    plain=True runs the plain twins on any device (for comparisons)."""
    config: AkazeConfig = statics.config
    base = base_stage_plain if plain else base_stage
    octave = fused_octave_plain if plain else fused_octave
    seed, modg = base(imgs, float(config.base_scale_offset))
    k = contrast_factor_from_modg(modg, config)
    groups = octave_groups(statics)
    lvl_oct, oct_fields = [], []
    for oi, (l0, n, _, _) in enumerate(groups):
        if oi > 0:
            k = k * config.contrast_octave_decay
        lt, lx, ly, score, sub, seed = octave(
            seed, k, tuple(statics.specs[l0 : l0 + n]), config.diffusivity,
            oi == 0, float(config.detector_threshold), oi + 1 < len(groups),
        )
        lvl_oct.append({"Lt": lt, "Lx": lx, "Ly": ly})
        oct_fields.append({"score": score, "sub": sub})
    return {"lvl_oct": tuple(lvl_oct), "oct": tuple(oct_fields)}
