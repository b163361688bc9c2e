"""The plain reference of the AKAZE front end: frames in, keypoints and
packed M-LDB descriptors out, in float32 PyTorch ops only.

A frozen copy of the arithmetic that the port's kernels are held to: the
FED schedule, the edge-replicating separable filters with their float32
taps, the contrast-factor histogram, the per-octave level chain (G_1 blur,
conductivity, FED sweeps, Scharr cascade, strict 3x3 maxima and the
packed sub-pixel fit), the exact per-level top-K, the symmetric
cross-level NMS, the global top-M and the fused describe (Cephes atan2,
orientation windows and cell means summed in a fixed order).  It imports
nothing of the program and runs on any device; every op is per frame, so a
block of frames gives the same answer as the whole batch.

`extract(frames, params, lowp=True)` is the control: every plane of the
scale space (the unit image, the sigma0 seed, |grad|, and each level's
Lt, Lx, Ly, Ldet) stored in bfloat16, the arithmetic in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

NEG = -3.0e38  # candidate-score sentinel
SUB_SCALE = 16000.0  # sub-pixel offsets in 1/16000 px, two 16-bit halves of an int32
WIN_SPLIT, CELL_PART = 3, 25  # summation order of the orientation windows and cell means
TWO_PI = float(np.float32(2.0 * math.pi))
_PI = float(np.float32(math.pi))


@dataclasses.dataclass(frozen=True)
class Params:
    """The front end's options, as a configuration file's "akaze" group
    names them (upstream AKAZE defaults)."""

    num_octaves: int = 4
    num_sublevels: int = 4
    base_scale_offset: float = 1.6
    derivative_factor: float = 1.5
    detector_threshold: float = 1e-3
    contrast_percentile: float = 0.7
    contrast_nbins: int = 300
    contrast_fallback: float = 0.03
    contrast_octave_decay: float = 0.75
    diffusivity: str = "pm_g2"
    fed_tau_max: float = 0.25
    min_octave_dim: int = 40
    descriptor_channels: int = 3
    descriptor_pattern_size: int = 10
    border_smax: float = 10.0 * math.sqrt(2.0)
    dedup_radius_factor: float = 0.5
    max_keypoints: int = 1024
    per_level_candidates: int = 256

    @classmethod
    def of(cls, group: dict) -> "Params":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in group.items() if k in names})

    @property
    def descriptor_words(self) -> int:
        bits = self.descriptor_channels * sum(c * (c - 1) // 2 for c in (4, 9, 16))
        return ((bits + 7) // 8 + 3) // 4


# ------------------------------------------------------------ FED schedule


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n < 4:
        return True
    if n % 2 == 0:
        return False
    f = 3
    while f * f <= n:
        if n % f == 0:
            return False
        f += 2
    return True


def fed_taus(t: float, tau_max: float) -> list:
    """The cosine-spaced FED step sizes of one cycle of diffusion time t,
    kappa-reordered."""
    n = int(math.ceil(math.sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1.0e-8))
    scale = 3.0 * t / (tau_max * n * (n + 1))
    if n <= 0:
        return []
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    tauh = [d / (math.cos(math.pi * (2 * j + 1) * c) ** 2) for j in range(n)]
    if n == 1:
        return tauh
    kappa = n // 2
    prime = n + 1
    while not _is_prime(prime):
        prime += 1
    tau, k = [], 0
    for _ in range(n):
        while True:
            index = ((k + 1) * kappa) % prime - 1
            if index < n:
                break
            k += 1
        tau.append(tauh[index])
        k += 1
    return tau


@dataclasses.dataclass(frozen=True)
class Level:
    octave: int
    esigma: float
    width: int
    height: int
    sigma_size: int
    border: int
    taus: tuple


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


def levels(width: int, height: int, p: Params) -> list:
    """Octaves x sublevels levels; a downsampled octave whose smaller side
    falls below min_octave_dim is dropped."""
    out, prev_etime, w, h = [], 0.0, width, height
    for octave in range(p.num_octaves):
        if octave > 0 and min(w, h) < p.min_octave_dim:
            break
        for sub in range(p.num_sublevels):
            esigma = p.base_scale_offset * math.pow(2.0, octave + sub / p.num_sublevels)
            etime = 0.5 * esigma * esigma
            sigma_size = _round_half_up(esigma * p.derivative_factor / (1 << octave))
            taus = () if not out else tuple(fed_taus(etime - prev_etime, p.fed_tau_max))
            out.append(Level(octave, esigma, w, h, sigma_size,
                             _round_half_up(p.border_smax * sigma_size) + 1, taus))
            prev_etime = etime
        w, h = w // 2, h // 2
    return out


def octave_groups(lv: list) -> list:
    """Per octave (first level, level count, h, w)."""
    groups, i = [], 0
    while i < len(lv):
        n = 1
        while i + n < len(lv) and lv[i + n].height == lv[i].height:
            n += 1
        groups.append((i, n, lv[i].height, lv[i].width))
        i += n
    return groups


class Statics:
    """Per-level tables of one frame size."""

    def __init__(self, width: int, height: int, p: Params):
        self.p = p
        self.levels = levels(width, height, p)
        self.groups = octave_groups(self.levels)
        self.num_levels = len(self.levels)
        self.h0, self.w0 = height, width
        self.widths = np.array([s.width for s in self.levels], np.int32)
        self.heights = np.array([s.height for s in self.levels], np.int32)
        self.octaves = np.array([s.octave for s in self.levels], np.int32)
        self.ratios = np.array([1 << s.octave for s in self.levels], np.float32)
        self.esigmas = np.array([s.esigma for s in self.levels], np.float32)
        self.sizes = (self.esigmas * p.derivative_factor).astype(np.float32)
        scale = np.floor(0.5 * self.sizes / self.ratios + 0.5).astype(np.int32)
        self.scales = np.maximum(scale, 1)


# ------------------------------------------------------------ filters


def gaussian_taps(sigma: float) -> np.ndarray:
    ksize = int(math.ceil(2.0 * (1.0 + (sigma - 0.8) / 0.3)))
    if ksize % 2 == 0:
        ksize += 1
    half = max(ksize, 3) // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def scharr_taps(sigma_size: int):
    ksize = 3 + 2 * (sigma_size - 1)
    w = 10.0 / 3.0
    norm = 1.0 / (2.0 * sigma_size * (w + 2.0))
    deriv = np.zeros(ksize, dtype=np.float32)
    deriv[0], deriv[-1] = -1.0, 1.0
    smooth = np.zeros(ksize, dtype=np.float32)
    smooth[0] = smooth[-1] = norm
    smooth[ksize // 2] = w * norm
    return deriv, smooth


def shift(img: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """img[..., clamp(i + d, 0, n - 1), ...] along `axis`."""
    if d == 0:
        return img
    n = img.shape[axis]
    return img.index_select(axis, torch.clamp(torch.arange(n, device=img.device) + d, 0, n - 1))


def filter_1d(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along `axis`, edges replicated, taps summed left to right
    with zero taps skipped."""
    half = len(taps) // 2
    acc = None
    for t, w in enumerate(np.asarray(taps, np.float32)):
        if w == 0.0:
            continue
        term = float(w) * shift(img, t - half, axis)
        acc = term if acc is None else acc + term
    return acc


def separable(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    return filter_1d(filter_1d(img, ky, -2), kx, -1)


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    k = gaussian_taps(sigma)
    return separable(img, k, k)


def scharr(img: torch.Tensor, along_x: bool, sigma_size: int = 1) -> torch.Tensor:
    deriv, smooth = scharr_taps(sigma_size)
    return separable(img, deriv, smooth) if along_x else separable(img, smooth, deriv)


def half_size(img: torch.Tensor) -> torch.Tensor:
    h2, w2 = img.shape[-2] // 2, img.shape[-1] // 2
    c = img[..., : 2 * h2, : 2 * w2]
    return 0.25 * (c[..., 0::2, 0::2] + c[..., 1::2, 0::2] + c[..., 0::2, 1::2] + c[..., 1::2, 1::2])


def ieee_sqrt(s: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root of s >= 0 (IEEE `sqrtf`): a
    float64 root rounded to float32, then moved to the neighbour whose
    rounding interval holds sqrt(s)."""
    sd = s.double()
    r = torch.sqrt(sd).float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    rd = r.double()
    hi = (rd + up.double()) * 0.5
    lo = (rd + down.double()) * 0.5
    return torch.where(sd > hi * hi, up, torch.where(sd < lo * lo, down, r))


# ------------------------------------------------------------ scale space


def contrast_factor(modg: torch.Tensor, p: Params) -> torch.Tensor:
    """Per frame: |grad| at the contrast percentile of a histogram of the
    interior pixels (the first bin whose cumulative count reaches it)."""
    b = modg.shape[0]
    m = modg[..., 1:-1, 1:-1].reshape(b, -1)
    hmax = m.amax(dim=1)
    valid = m > 0.0
    npoints = valid.sum(dim=1)
    nbins = p.contrast_nbins
    safe = torch.where(hmax > 0, hmax, torch.ones_like(hmax))
    bins = torch.clamp(torch.floor(nbins * (m / safe[:, None])).to(torch.int32), max=nbins - 1)
    frame = torch.arange(b, device=m.device, dtype=torch.int64)[:, None].expand_as(bins)
    flat = (frame * nbins + bins.to(torch.int64))[valid]
    counts = torch.bincount(flat, minlength=b * nbins).reshape(b, nbins).to(torch.float32)
    crossed = torch.cumsum(counts, dim=1) >= (npoints.to(torch.float32) * p.contrast_percentile)[:, None]
    idx = (~crossed).sum(dim=1).to(torch.float32)
    k = safe * (idx + 1.0) / nbins
    bad = (hmax <= 0.0) | ~crossed.any(dim=1)
    return torch.where(bad, torch.full_like(k, p.contrast_fallback), k)


def conductivity(lx, ly, k, kind: str) -> torch.Tensor:
    grad2 = (lx * lx + ly * ly) / (k * k)
    if kind == "pm_g2":
        return 1.0 / (1.0 + grad2)
    if kind == "pm_g1":
        return torch.exp(-grad2)
    if kind == "weickert":
        g2_4 = grad2 * grad2
        g2_4 = g2_4 * g2_4
        safe = torch.where(g2_4 > 0, g2_4, torch.ones_like(g2_4))
        return torch.where(grad2 > 0.0, 1.0 - torch.exp(torch.full_like(safe, -3.315) / safe),
                           torch.ones_like(g2_4))
    raise ValueError(f"unknown diffusivity {kind!r}")


def fed_cycle(lt: torch.Tensor, g: torch.Tensor, taus: Sequence[float]) -> torch.Tensor:
    """Explicit FED steps of dL/dt = div(g grad L), zero-flux borders."""
    for tau in taus:
        step = (
            (g + shift(g, 1, -1)) * (shift(lt, 1, -1) - lt)
            + (g + shift(g, -1, -1)) * (shift(lt, -1, -1) - lt)
            + (g + shift(g, 1, -2)) * (shift(lt, 1, -2) - lt)
            + (g + shift(g, -1, -2)) * (shift(lt, -1, -2) - lt)
        )
        lt = lt + float(np.float32(0.5 * tau)) * step
    return lt


def hessian_response(lsmooth: torch.Tensor, s: int):
    """(Lx * s, Ly * s, Ldet) of the sigma_size-scaled Scharr cascade."""
    lx = scharr(lsmooth, True, s)
    ly = scharr(lsmooth, False, s)
    lxx = scharr(lx, True, s)
    lyy = scharr(ly, False, s)
    lxy = scharr(lx, False, s)
    s2 = float(s * s)
    return lx * float(s), ly * float(s), (lxx * s2) * (lyy * s2) - (lxy * s2) * (lxy * s2)


def pack_sub(ox, oy, keep) -> torch.Tensor:
    zero = torch.zeros_like(ox)
    qx = torch.round((torch.clamp(torch.where(keep, ox, zero), -1.0, 1.0) + 1.0) * SUB_SCALE)
    qy = torch.round((torch.clamp(torch.where(keep, oy, zero), -1.0, 1.0) + 1.0) * SUB_SCALE)
    packed = qx.to(torch.int32) * 65536 + qy.to(torch.int32)
    return torch.where(keep, packed, torch.full_like(packed, -1))


def unpack_sub(packed):
    keep = packed >= 0
    p = torch.clamp(packed, min=0)
    qx = torch.div(p, 65536, rounding_mode="floor")
    qy = p - qx * 65536
    inv = float(np.float32(1.0 / SUB_SCALE))
    return qx.to(torch.float32) * inv - 1.0, qy.to(torch.float32) * inv - 1.0, keep


def score_fields(ldet: torch.Tensor, border: int, threshold: float):
    """Strict 3x3-max candidate score (edges replicated) and the packed
    quadratic sub-pixel fit of one level."""
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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def scale_space(imgs: torch.Tensor, st: Statics, lowp: bool = False):
    """(B, H, W) float32 in [0, 1] -> per octave level-major (n, B, h, w)
    {"Lt", "Lx", "Ly"} planes and {"score", "sub"} detect fields."""
    p = st.p
    q = _bf16 if lowp else (lambda t: t)
    imgs = q(imgs)
    seed = q(blur(imgs, float(p.base_scale_offset)))
    sm = blur(imgs, 1.0)
    gx, gy = scharr(sm, True), scharr(sm, False)
    k = contrast_factor(q(ieee_sqrt(gx * gx + gy * gy)), p)
    planes, fields = [], []
    for oi, (l0, n, _, _) in enumerate(st.groups):
        if oi > 0:
            k = k * p.contrast_octave_decay
        x = seed
        out = {key: [] for key in ("Lt", "Lx", "Ly", "score", "sub")}
        for li, lv in enumerate(st.levels[l0 : l0 + n]):
            if oi == 0 and li == 0:
                lsmooth = x
            else:
                lsmooth = blur(x, 1.0)
                g = conductivity(scharr(lsmooth, True), scharr(lsmooth, False), k.reshape(-1, 1, 1),
                                 p.diffusivity)
                x = q(fed_cycle(x, g, lv.taus))
            lx, ly, ldet = (q(t) for t in hessian_response(lsmooth, lv.sigma_size))
            score, sub = score_fields(ldet, int(lv.border), float(p.detector_threshold))
            for key, val in zip(("Lt", "Lx", "Ly", "score", "sub"), (x, lx, ly, score, sub)):
                out[key].append(val)
        seed = q(half_size(x))
        planes.append({key: torch.stack(out[key]) for key in ("Lt", "Lx", "Ly")})
        fields.append({key: torch.stack(out[key]) for key in ("score", "sub")})
    return planes, fields


# ------------------------------------------------------------ detection


def topk_stable(values: torch.Tensor, k: int):
    """Top-k along the last axis of float32 values, ties to the lower
    index: torch.topk on unique int64 keys (score bits, reversed index)."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    n = values.shape[-1]
    index = torch.arange(n, device=values.device, dtype=torch.int64)
    idx = torch.topk(ordered * (1 << 32) + (n - 1 - index), k, dim=-1, sorted=True).indices
    return torch.gather(values, -1, idx), idx


def candidates(fields, st: Statics) -> dict:
    """Exact per-level top-K of the candidate scores: (B, L, K) fields."""
    K = st.p.per_level_candidates
    resp_g, yi_g, xi_g = [], [], []
    for (_, n, h, w), f in zip(st.groups, fields):
        score = f["score"]
        B = score.shape[1]
        k = min(K, h * w)
        resp, idx = topk_stable(score.reshape(n * B, h * w), k)
        if k < K:
            resp = torch.nn.functional.pad(resp, (0, K - k), value=NEG)
            idx = torch.nn.functional.pad(idx, (0, K - k))
        resp_g.append(resp.reshape(n, B, K).transpose(0, 1))
        yi_g.append(torch.div(idx, w, rounding_mode="floor").reshape(n, B, K).transpose(0, 1))
        xi_g.append((idx % w).reshape(n, B, K).transpose(0, 1))
    resp = torch.cat(resp_g, dim=1)
    yi = torch.cat(yi_g, dim=1).to(torch.int32)
    xi = torch.cat(xi_g, dim=1).to(torch.int32)
    return {"resp": resp, "yi": yi, "xi": xi, "flat": yi * st.w0 + xi, "valid": resp > NEG}


def nms(cand: dict, st: Statics) -> torch.Tensor:
    """Symmetric NMS over the same and adjacent levels: P falls where some
    valid Q within 0.5 * size[max level] beats it on (response, earlier
    level-major raster index)."""
    dev = cand["resp"].device
    L = st.num_levels
    ratios = torch.as_tensor(st.ratios, device=dev)[:, None]
    x0 = cand["xi"].to(torch.float32) * ratios
    y0 = cand["yi"].to(torch.float32) * ratios
    resp, valid = cand["resp"], cand["valid"]
    tie = torch.arange(L, dtype=torch.int32, device=dev)[:, None] * (st.h0 * st.w0) + cand["flat"]
    r2 = torch.as_tensor((st.p.dedup_radius_factor * st.sizes) ** 2, device=dev)
    r2_next = torch.cat([r2[1:], torch.zeros_like(r2[:1])])

    def along(a, d, fill):
        pad = torch.full_like(a[:, :1], fill)
        return torch.cat([pad, a[:, :-1]], dim=1) if d == 1 else torch.cat([a[:, 1:], pad], dim=1)

    suppressed = torch.zeros_like(valid)
    for d, r2_pair in ((0, r2), (1, r2), (-1, r2_next)):
        if d == 0:
            qx, qy, qresp, qtie, qvalid = x0, y0, resp, tie, valid
        else:
            qx, qy = along(x0, d, 0.0), along(y0, d, 0.0)
            qresp, qtie, qvalid = along(resp, d, NEG), along(tie, d, 0), along(valid, d, False)
        dx = x0[..., :, None] - qx[..., None, :]
        dy = y0[..., :, None] - qy[..., None, :]
        close = dx * dx + dy * dy <= r2_pair[:, None, None]
        beats = (qresp[..., None, :] > resp[..., :, None]) | (
            (qresp[..., None, :] == resp[..., :, None]) & (qtie[..., None, :] < tie[..., :, None]))
        suppressed |= (close & beats & qvalid[..., None, :]).any(dim=-1)
    return valid & ~suppressed


def detect(fields, st: Statics) -> dict:
    """Candidates -> NMS -> global top-M -> sub-pixel offsets from the
    packed fields: (B, M) keypoint fields."""
    cand = candidates(fields, st)
    valid = nms(cand, st)
    B, L, K = valid.shape
    flat_resp = torch.where(valid, cand["resp"], torch.full_like(cand["resp"], NEG)).reshape(B, L * K)
    M = st.p.max_keypoints
    k = min(M, L * K)
    top_resp, order = topk_stable(flat_resp, k)
    if k < M:
        top_resp = torch.nn.functional.pad(top_resp, (0, M - k), value=NEG)
        order = torch.nn.functional.pad(order, (0, M - k))
    npx = st.h0 * st.w0
    lvl = torch.arange(L, dtype=torch.int32, device=valid.device)[:, None].expand(L, K)
    sel = torch.gather((lvl * npx + cand["flat"]).reshape(B, L * K), 1, order)
    class_id = torch.div(sel, npx, rounding_mode="floor")
    rem = sel - class_id * npx
    yi = torch.div(rem, st.w0, rounding_mode="floor")
    xi = rem - yi * st.w0

    frame = torch.arange(B, device=valid.device)[:, None].expand_as(class_id)
    packed = torch.full_like(class_id, -1)
    for (l0, n, h, w), f in zip(st.groups, fields):
        inside = (class_id >= l0) & (class_id < l0 + n)
        li = torch.clamp(class_id - l0, 0, n - 1).long()
        packed = torch.where(inside, f["sub"][li, frame, torch.clamp(yi, 0, h - 1).long(),
                                              torch.clamp(xi, 0, w - 1).long()], packed)
    ox, oy, keep = unpack_sub(packed)
    zero = torch.zeros_like(ox)
    cls = class_id.long()
    r = torch.as_tensor(st.ratios, device=valid.device)[cls]
    return {
        "x": (xi.to(torch.float32) + torch.where(keep, ox, zero)) * r,
        "y": (yi.to(torch.float32) + torch.where(keep, oy, zero)) * r,
        "response": top_resp,
        "size": torch.as_tensor(st.sizes, device=valid.device)[cls],
        "octave": torch.as_tensor(st.octaves, device=valid.device)[cls],
        "class_id": class_id,
        "valid": (top_resp > NEG) & keep,
    }


# ------------------------------------------------------------ description


class Pattern:
    """The orientation circle and windows and the M-LDB grids."""

    def __init__(self, p: Params):
        offs = [(i, j) for i in range(-6, 7) for j in range(-6, 7) if i * i + j * j < 36]
        self.ori_di = np.array([o[0] for o in offs], np.float32)
        self.ori_dj = np.array([o[1] for o in offs], np.float32)
        self.ori_w = np.exp(-(self.ori_di**2 + self.ori_dj**2) / (2.0 * 2.5 * 2.5)).astype(np.float32)
        ang1 = np.arange(0.0, 2.0 * math.pi, 0.15)
        self.win_lo = ang1.astype(np.float32)
        self.win_hi = (ang1 + math.pi / 3.0).astype(np.float32)
        self.win_wrap = self.win_hi > 2.0 * math.pi
        size = p.descriptor_pattern_size
        unique: dict = {}
        raw = []
        for step in (size, int(math.ceil(2.0 * size / 3.0)), size // 2):
            entries, ci = [], 0
            for i in range(-size, size, step):
                for j in range(-size, size, step):
                    for k in range(i, i + step):
                        for m in range(j, j + step):
                            entries.append((unique.setdefault((k, m), len(unique)), ci))
                    ci += 1
            raw.append((entries, ci))
        self.grids = []
        for entries, n_cells in raw:
            mm = np.zeros((len(unique), n_cells), np.float32)
            for u, c in entries:
                mm[u, c] += 1.0
            mm /= mm.sum(axis=0, keepdims=True)
            members = np.stack([np.nonzero(mm[:, c])[0] for c in range(n_cells)])
            weights = mm[members[:, 0], np.arange(n_cells)].astype(np.float32)
            pa, pb = np.triu_indices(n_cells, k=1)
            self.grids.append((members, weights, pa, pb))
        offs = np.array(sorted(unique, key=unique.get), np.float32)
        self.offk, self.offl = offs[:, 0], offs[:, 1]
        self.n_samples = len(unique)
        self.words = p.descriptor_words


def atan2_cephes(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    ax, ay = torch.abs(x), torch.abs(y)
    one = torch.ones_like(ax)
    t = ay / torch.where(ax > 0, ax, one)
    big = t > 2.414213562373095
    mid = (t > 0.4142135623730951) & ~big
    zero = torch.zeros_like(t)
    base = torch.where(big, zero + _PI / 2, torch.where(mid, zero + _PI / 4, zero))
    safe_t = torch.where(big, torch.maximum(t, one), t)
    tr = torch.where(big, -1.0 / safe_t, torch.where(mid, (t - 1.0) / (t + 1.0), t))
    z = tr * tr
    p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z + 1.99777106478e-1) * z - 3.33329491539e-1
    q = base + tr + tr * z * p
    q = torch.where(ax > 0, q, zero + _PI / 2)
    q = torch.where((ax == 0) & (ay == 0), zero, q)
    q = torch.where(x < 0, _PI - q, q)
    return torch.where(y < 0, -q, q)


def mod_2pi(a: torch.Tensor) -> torch.Tensor:
    r = torch.fmod(a, TWO_PI)
    return torch.where(r < 0, r + TWO_PI, r)


def _window_sums(inside: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Window sums over WIN_SPLIT sample ranges, each summed in sample
    order, then the range sums added in order."""
    S = r.shape[-1]
    n = -(-S // WIN_SPLIT)
    vals = torch.where(inside, r[:, None, :], torch.zeros((), dtype=r.dtype, device=r.device))
    vals = torch.nn.functional.pad(vals, (0, WIN_SPLIT * n - S)).reshape(*vals.shape[:2], WIN_SPLIT, n)
    acc = torch.zeros(vals.shape[:3], dtype=r.dtype, device=r.device)
    for k in range(n):
        acc = acc + vals[..., k]
    out = acc[..., 0]
    for j in range(1, WIN_SPLIT):
        out = out + acc[..., j]
    return out


def _cell_means(chans: torch.Tensor, members, weights) -> torch.Tensor:
    """(3, N, S) samples -> (3, N, C) means: members cut into parts of
    CELL_PART, each part summed from 0, the part sums added in order."""
    idx = torch.as_tensor(members, device=chans.device)
    cw = torch.as_tensor(weights, device=chans.device)
    mean = None
    for q0 in range(0, idx.shape[1], CELL_PART):
        acc = torch.zeros(chans.shape[:2] + (idx.shape[0],), dtype=chans.dtype, device=chans.device)
        for j in range(q0, min(idx.shape[1], q0 + CELL_PART)):
            acc = acc + chans[:, :, idx[:, j]] * cw
        mean = acc if mean is None else mean + acc
    return mean


def describe(kp: dict, planes, st: Statics, pat: Pattern):
    """(angles (B, M), descriptors (B, M, W) int32) of the keypoints on the
    per-octave planes; invalid slots get zeros."""
    B, M = kp["x"].shape
    dev = kp["x"].device
    lvl = kp["class_id"].reshape(-1).long()
    group = np.zeros(st.num_levels, np.int64)
    index = np.zeros(st.num_levels, np.int64)
    for g, (l0, n, _, _) in enumerate(st.groups):
        group[l0 : l0 + n] = g
        index[l0 : l0 + n] = np.arange(n)
    tab = lambda a: torch.as_tensor(a, device=dev)[lvl]
    ratio = tab(st.ratios)
    xf, yf = (kp["x"].reshape(-1) / ratio)[:, None], (kp["y"].reshape(-1) / ratio)[:, None]
    sc = tab(st.scales.astype(np.float32))[:, None]
    xmax = tab(st.widths - 1)[:, None]
    ymax = tab(st.heights - 1)[:, None]
    grp, li = tab(group)[:, None], tab(index)[:, None]
    frame = (torch.arange(B * M, device=dev) // M)[:, None]
    names = ("Lt", "Lx", "Ly")

    def sample(channels, offx, offy):
        ix = torch.minimum(torch.clamp(torch.floor(xf + offx * sc + 0.5).to(torch.int32), min=0), xmax)
        iy = torch.minimum(torch.clamp(torch.floor(yf + offy * sc + 0.5).to(torch.int32), min=0), ymax)
        outs = None
        for g, pl in enumerate(planes):
            n, _, h, w = pl["Lt"].shape
            sel = grp == g
            idx = torch.where(sel, ((li * B + frame) * h + iy.long()) * w + ix.long(), 0)
            vals = [pl[names[c]].reshape(-1)[idx] for c in channels]
            outs = vals if outs is None else [torch.where(sel, v, o) for v, o in zip(vals, outs)]
        return outs

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    sx, sy = sample((1, 2), t(pat.ori_di), t(pat.ori_dj))
    w = t(pat.ori_w)
    rx, ry = w * sx, w * sy
    ang = mod_2pi(atan2_cephes(ry, rx))[:, None, :]
    lo, hi = t(pat.win_lo)[:, None], t(pat.win_hi)[:, None]
    wrap = torch.as_tensor(pat.win_wrap, device=dev)[:, None]
    inside = torch.where(wrap, (ang > lo) | (ang < hi - TWO_PI), (ang > lo) & (ang < hi))
    sum_x, sum_y = _window_sums(inside, rx), _window_sums(inside, ry)
    best = torch.argmax(sum_x * sum_x + sum_y * sum_y, dim=-1, keepdim=True)
    angle = mod_2pi(atan2_cephes(sum_y.gather(1, best)[:, 0], sum_x.gather(1, best)[:, 0]))

    co, si = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    offk, offl = t(pat.offk), t(pat.offl)
    ri, gx, gy = sample((0, 1, 2), -offl * si + offk * co, offl * co + offk * si)
    chans = torch.stack([ri, gx * co + gy * si, -gx * si + gy * co])
    bits = []
    for members, weights, pa, pb in pat.grids:
        means = _cell_means(chans, members, weights)
        pa = torch.as_tensor(pa, device=dev).long()
        pb = torch.as_tensor(pb, device=dev).long()
        bits.extend(means[:, :, pa] > means[:, :, pb])
    allbits = torch.cat(bits, dim=1)
    allbits = torch.nn.functional.pad(allbits, (0, pat.words * 32 - allbits.shape[1]))
    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64, device=dev)
    words = (allbits.reshape(-1, pat.words, 32).long() * weights).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    valid = kp["valid"].reshape(-1)
    angle = torch.where(valid, angle, torch.zeros_like(angle))
    words = torch.where(valid[:, None], words, torch.zeros_like(words))
    return angle.reshape(B, M), words.reshape(B, M, -1)


def extract(frames: torch.Tensor, p: Params, lowp: bool = False, block: int = 32) -> dict:
    """(B, H, W) uint8 frames -> {"x", "y", "response", "size", "octave",
    "class_id", "angle", "valid"} (B, M) and "descriptors" (B, M, W), in
    blocks of `block` frames on the frames' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = Statics(frames.shape[-1], frames.shape[-2], p)
    pat = Pattern(p)
    parts = []
    for b0 in range(0, frames.shape[0], block):
        imgs = frames[b0 : b0 + block].to(torch.float32) / 255.0
        planes, fields = scale_space(imgs.contiguous(), st, lowp)
        kp = detect(fields, st)
        kp["angle"], kp["descriptors"] = describe(kp, planes, st, pat)
        parts.append(kp)
        del planes, fields
    return {key: torch.cat([part[key] for part in parts]) for key in parts[0]}
