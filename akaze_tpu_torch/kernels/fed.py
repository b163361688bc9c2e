"""Kernels 1 (`base_stage`), 2 (`fused_octave`) and 5 (`fused_level`) with
their plain PyTorch twins, the packed sub-pixel format and the two
scale-space builders (counterpart of the JAX package's
`akaze_tpu/kernels/fed_pallas.py`): the batched per-octave build of the
main path, and the per-level build (kernel 1, then kernel 5 once per level)
behind the single-image `extract_fn`.

Each wrapper runs its plain twin for CPU tensors and launches its CUDA
kernel (`csrc/fed.cu`) for CUDA tensors; there is no fallback between the
two.  The builder's outputs keep the TPU layout: per octave, level-major
(n, B, h, w) stacks `Lt/Lx/Ly` and detect fields `score` (f32) / `sub`
(packed int32), and each octave hands the next its in-kernel half-size
seed.  Kernels 2 and 5 run the launches that `level_plan` gives each level
(tiles, halos, whole planes, a fused detect cascade); the plan is pure
Python and `tests/test_torch_fed_plan.py` replays it on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

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
from akaze_tpu_torch.utils.profiling import span

#: Sub-pixel offsets quantise to 1/16000 px in two 16-bit halves of one
#: int32 word; -1 marks a rejected fit.
SUB_SCALE = 16000.0
NEG = -3.0e38  # candidate-score sentinel
_DIFFUSIVITY_CODE = {Diffusivity.PM_G1: 0, Diffusivity.PM_G2: 1, Diffusivity.WEICKERT: 2}
_MAXTAPS = 9
#: __global__ launches made by the wrappers of kernels 2 and 5 (several per
#: call; their C entry points report them).  `_build.launches` counts the
#: wrapper calls.
device_launches = {"fused_octave": 0, "fused_level": 0}

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


# ------------------------------------------------------------------ kernel 1


def ieee_sqrt(s: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root of a float32 tensor s >= 0 (the
    IEEE `sqrtf`), on any device and whatever torch's CPU root does: a
    float64 root rounded to float32, then moved to the float32 neighbour
    whose rounding interval holds sqrt(s).  The test is exact: the midpoint
    of two adjacent float32 values and its square are exact in float64, and
    sqrt(s) never lies on a midpoint.  torch's float32 CPU root is 1 ULP off
    on ~0.7 % of pixels, and was seen up to ~4,000 ULP off on the first
    call of a fresh 8-thread process."""
    sd = s.double()
    return round_root(sd, torch.sqrt(sd).float())


def round_root(sd: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 root of float64 sd (a float32 value)
    from a float32 root r at most 1 ULP off."""
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    rd = r.double()
    hi = (rd + up.double()) * 0.5
    lo = (rd + down.double()) * 0.5
    return torch.where(sd > hi * hi, up, torch.where(sd < lo * lo, down, r))


def base_stage_plain(imgs: torch.Tensor, sigma0: float):
    """(B, H, W) -> (seed = G_sigma0 * img, modg = |Scharr grad(G_1 * img)|),
    the root IEEE-rounded as kernel 1's `sqrtf` (`ieee_sqrt`)."""
    seed = gaussian_blur(imgs, sigma0)
    sm = gaussian_blur(imgs, 1.0)
    gx = scharr(sm, 1, 0, 1)
    gy = scharr(sm, 0, 1, 1)
    return seed, ieee_sqrt(gx * gx + gy * gy)


def _check_planes(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32 or t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{what}: expects a contiguous float32 (B, H, W) tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")


#: Kernel 1's output tile (rows, cols) and halo: 9 taps of G_sigma0 read 4
#: pixels around the tile, G_1's 5 taps then the Scharr 2 + 1.
BASE_TILE = (64, 64)
BASE_HALO = 4


def _nonzero_taps(taps: np.ndarray, what: str) -> np.ndarray:
    """The taps without the zero taps at both ends (a small sigma underflows
    them); summing the rest left to right is the reference's sum, which
    skips zero taps."""
    nz = np.nonzero(taps)[0]
    lead, trail = int(nz[0]), len(taps) - 1 - int(nz[-1])
    if lead != trail or len(nz) != len(taps) - lead - trail:
        raise ValueError(f"{what}: the kernel takes taps that are zero only at both ends alike")
    return taps[lead : len(taps) - trail]


def base_stage(imgs: torch.Tensor, sigma0: float):
    """Kernel 1 on CUDA tensors, its plain twin on CPU tensors."""
    if imgs.device.type == "cpu":
        return base_stage_plain(imgs, sigma0)
    _build.require_cuda(imgs, "base_stage")
    _check_planes(imgs, "base_stage")
    g0 = _nonzero_taps(gaussian_kernel(sigma0), "base_stage")
    g1 = gaussian_kernel(1.0)
    if len(g0) > _MAXTAPS:
        raise ValueError(f"base_stage: sigma0 = {sigma0} needs {len(g0)} taps, the kernel takes {_MAXTAPS}")
    _, s1 = scharr_kernels(1)
    B, H, W = imgs.shape
    seed = torch.empty_like(imgs)
    modg = torch.empty_like(imgs)
    fn = _build.function("fed", "base_stage",
                         [_P, _P, _P, _I, _I, _I, _FP, _I, _FP, _I, _F, _F, _I, _I, _I, _P])
    with torch.cuda.device(imgs.device):
        err = fn(imgs.data_ptr(), seed.data_ptr(), modg.data_ptr(), B, H, W,
                 (_F * len(g0))(*g0), len(g0), (_F * len(g1))(*g1), len(g1),
                 float(s1[0]), float(s1[1]), *BASE_TILE, BASE_HALO, _build.stream_of(imgs))
    _build.check("fed", err, "base_stage")
    _build.launches["base_stage"] += 1
    return seed, modg


# ------------------------------------------------------ the level-chain plan

#: Shared memory one block may take on sm_90 (227 KB), and what a launch
#: keeps there: three float32 planes of its loaded extent.
SMEM_MAX = 232_448
_SMEM_PER_PX = 12
#: Output tile (rows, cols) of a tiled launch, and the smaller one taken
#: when the batch gives too few blocks to fill the card (under two per SM).
TILE = (64, 64)
SMALL_TILE = (16, 32)
#: Threads of a block.  Each walks runs of rows of one column and keeps the
#: rows a stage reuses in registers, so fewer threads make longer runs; a
#: block that holds a whole plane of 8192 pixels or more alone on its SM
#: takes PLANE_THREADS.  The kernels are built for these two sizes only.
THREADS = 256
PLANE_THREADS = 1024
#: Frames from which whole-plane blocks (one per frame) fill the card.
_PLANE_BATCH = 64
#: Sweeps one launch takes at most (the kernel's argument table).
MAX_LAUNCH_SWEEPS = 256
_STAGE_CODE = {"diffuse": 0, "detect": 1, "level": 2}


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a level chain.  stage "diffuse": G_1 blur,
    conductivity and `sweeps` FED sweeps (halo >= sweeps + 3); "detect": the
    derivative cascade and score (halo >= 2s + 1); "level": "diffuse" and
    "detect" in one launch, Lsmooth kept in a fourth shared plane (halo >=
    sweeps + 3 and >= 2s + 3).  Each block of `threads` owns one (rows,
    cols) output `tile` and loads it with `halo` pixels around it, clipped
    to the plane; `smem` is its shared memory in bytes."""

    stage: str
    tile: tuple
    halo: int
    sweeps: int
    smem: int
    threads: int


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """schedule "tiled" (the level's sweeps in one launch over tiles) or
    "plane" (one block per frame holds the whole plane); the first level of
    the scale space is "tiled" with its detect launch alone."""

    schedule: str
    launches: tuple

    @property
    def sweeps(self) -> int:
        return sum(l.sweeps for l in self.launches)


def _launch(stage, h, w, tile, halo, sweeps=0, threads=THREADS) -> Launch:
    per_px = _SMEM_PER_PX + (4 if stage == "level" else 0)
    smem = per_px * min(h, tile[0] + 2 * halo) * min(w, tile[1] + 2 * halo)
    return Launch(stage, tuple(tile), halo, sweeps, smem, threads)


def level_plan(h: int, w: int, n_taus, sigma_sizes, first: bool, batch: int, sms: int) -> tuple:
    """The launches of each level of one octave of `batch` (h, w) planes on
    a card with `sms` multiprocessors: n_taus[i] FED sweeps and Scharr size
    sigma_sizes[i] at level i (first: level 0 is the first level of the
    scale space, which takes the seed as it is).

    A level's diffusion (blur, conductivity and all its sweeps) is one
    launch.  It runs on whole planes, one block per frame ("plane"), where
    three planes of a frame fit in one block's shared memory and the batch
    has 64 frames or more; else on tiles with a halo of 3 + its sweeps
    ("tiled"): TILE, or SMALL_TILE where the batch gives fewer than two
    blocks per SM, halved until the launch fits.  That launch also runs the
    level's detect cascade ("level") where its four planes take at most a
    third of the shared memory (three blocks per SM); else a detect launch
    with halo 2s + 1 follows.  Blocks have THREADS threads (PLANE_THREADS
    for large whole planes).  Raises ValueError where a launch cannot fit."""
    big = batch * -(-h // TILE[0]) * -(-w // TILE[1])
    tile = TILE if big >= 2 * sms else SMALL_TILE
    whole = batch >= _PLANE_BATCH and _SMEM_PER_PX * h * w <= SMEM_MAX
    plans = []
    for i, (n, s) in enumerate(zip(n_taus, sigma_sizes)):
        detect = _launch("detect", h, w, tile, 2 * int(s) + 1)
        if first and i == 0:
            plans.append(LevelPlan("tiled", (detect,)))
            continue
        if n > MAX_LAUNCH_SWEEPS:
            raise ValueError(f"level_plan: {n} FED sweeps in a level, one launch takes {MAX_LAUNCH_SWEEPS}")
        schedule, t = ("plane", (h, w)) if whole else ("tiled", tile)
        nt = PLANE_THREADS if whole and h * w >= 8192 else THREADS
        level = _launch("level", h, w, t, max(n + 3, 2 * int(s) + 3), n, nt)
        if level.smem <= SMEM_MAX // 3:
            plans.append(LevelPlan(schedule, (level,)))
            continue
        diffuse = _launch("diffuse", h, w, t, n + 3, n, nt)
        while diffuse.smem > SMEM_MAX and diffuse.tile != (1, 1):
            diffuse = _launch("diffuse", h, w, (max(1, t[0] // 2), max(1, t[1] // 2)), n + 3, n, nt)
            t = diffuse.tile
        if diffuse.smem > SMEM_MAX:
            raise ValueError(f"level_plan: {n} sweeps on a {h}x{w} plane need a halo of {n + 3}, "
                             f"which does not fit in {SMEM_MAX} bytes of shared memory")
        plans.append(LevelPlan(schedule, (diffuse, detect)))
    return tuple(plans)


def plan_launches(plans, with_half: bool = False) -> int:
    """The __global__ launches of one octave's (or one level's) plans."""
    return sum(len(p.launches) for p in plans) + int(with_half)


def _plan_table(plans):
    """(launches per level, flat {stage, tile rows, tile cols, halo,
    sweeps, threads} ints) as ctypes arrays."""
    flat = [v for p in plans for l in p.launches
            for v in (_STAGE_CODE[l.stage], l.tile[0], l.tile[1], l.halo, l.sweeps, l.threads)]
    return (_I * len(plans))(*[len(p.launches) for p in plans]), (_I * len(flat))(*flat)


def _lsmooth_scratch(plans, seed, first: bool):
    """A plane for Lsmooth where a level past the first has a separate
    detect launch, else None."""
    later = plans[1:] if first else plans
    return torch.empty_like(seed) if any(p.launches[0].stage == "diffuse" for p in later) else None


def specs_plan(specs, h, w, first: bool, batch: int, sms: int) -> tuple:
    """`level_plan` of the levels `specs` on `batch` (h, w) planes."""
    return level_plan(h, w, [len(s.taus) for s in specs], [s.sigma_size for s in specs], first, batch, sms)


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


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
    x = seed
    lts, lxs, lys, scores, subs = [], [], [], [], []
    for li, spec in enumerate(specs):
        x, lx, ly, ldet = fused_level_batched_plain(x, k, spec, diffusivity, first and li == 0)
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
                 threshold: float, with_half: bool, plan=None):
    """Kernel 2 on CUDA tensors (one entry per octave: per level the
    launches of its `level_plan`, by default the one for these planes, then
    the half-size launch), its plain twin on CPU tensors."""
    if seed.device.type == "cpu":
        return fused_octave_plain(seed, k, specs, diffusivity, first, threshold, with_half)
    _build.require_cuda(seed, "fused_octave")
    _check_planes(seed, "fused_octave")
    if k.dtype != torch.float32 or k.shape != seed.shape[:1] or k.device != seed.device:
        raise ValueError("fused_octave: k must be a float32 (B,) tensor on the seed's device")
    k = k.contiguous()
    B, h, w = seed.shape
    n = len(specs)
    plan = specs_plan(specs, h, w, first, B, _sms(seed)) if plan is None else plan
    out = lambda dtype=torch.float32: torch.empty((n, B, h, w), dtype=dtype, device=seed.device)
    lt, lx, ly, score, sub = out(), out(), out(), out(), out(torch.int32)
    half = torch.empty((B, h // 2, w // 2), device=seed.device) if with_half else None
    lsmooth = _lsmooth_scratch(plan, seed, first)

    n_sweeps = [len(s.taus) for s in specs]
    half_taus = [float(np.float32(0.5 * t)) for s in specs for t in s.taus]
    sn, swn = [], []
    for s in specs:
        _, smooth = scharr_kernels(s.sigma_size)
        sn.append(float(smooth[0]))
        swn.append(float(smooth[len(smooth) // 2]))
    g1 = gaussian_kernel(1.0)
    _, s1 = scharr_kernels(1)
    counts, table = _plan_table(plan)
    launched = _I(0)
    fn = _build.function("fed", "fused_octave", [
        _P, _P, _P, _P, _P, _P, _P, _P,  # seed, k, lt, lx, ly, score, sub, half
        _P,  # scratch: lsmooth
        _I, _I, _I, _I, _I, _I,  # B, h, w, n, first, kind
        _IP, _FP, _IP, _FP, _FP, _IP, _F,  # per-level tables, threshold
        _FP, _I, _F, _F,  # G_1 taps, sigma-1 Scharr taps
        _IP, _IP, _IP, _P,  # plan, launches made, stream
    ])
    with torch.cuda.device(seed.device):
        err = fn(seed.data_ptr(), k.data_ptr(), lt.data_ptr(), lx.data_ptr(), ly.data_ptr(),
                 score.data_ptr(), sub.data_ptr(), None if half is None else half.data_ptr(),
                 None if lsmooth is None else lsmooth.data_ptr(),
                 B, h, w, n, int(first), _DIFFUSIVITY_CODE[diffusivity],
                 (_I * n)(*n_sweeps), (_F * max(1, len(half_taus)))(*half_taus),
                 (_I * n)(*[s.sigma_size for s in specs]), (_F * n)(*sn), (_F * n)(*swn),
                 (_I * n)(*[s.border for s in specs]), float(threshold),
                 (_F * len(g1))(*g1), len(g1), float(s1[0]), float(s1[1]),
                 counts, table, ctypes.byref(launched), _build.stream_of(seed))
    _build.check("fed", err, "fused_octave")
    _build.launches["fused_octave"] += 1
    device_launches["fused_octave"] += launched.value
    return lt, lx, ly, score, sub, half


# ------------------------------------------------------------------ kernel 5


def fused_level_batched_plain(seed, k, spec, diffusivity: Diffusivity, first_level: bool = False):
    """One level for a batch: seed (B, h, w) — the sigma0 blur at level 0
    (first_level), else the previous level's Lt, half sized at an octave
    change — and k (B,) -> (Lt, Lx, Ly, Ldet), each (B, h, w)."""
    if first_level:
        lsmooth = lt = seed
    else:
        lsmooth = gaussian_blur(seed, 1.0)
        g = conductivity(scharr(lsmooth, 1, 0, 1), scharr(lsmooth, 0, 1, 1), k.reshape(-1, 1, 1), diffusivity)
        lt = fed_cycle(seed, g, spec.taus)
    return (lt, *detector_response_level(lsmooth, spec.sigma_size))


def fused_level_batched(seed, k, spec, diffusivity: Diffusivity, first_level: bool = False, plan=None):
    """Kernel 5 on CUDA tensors (kernel 2's level chain with Ldet written
    out: the launches of the level's `level_plan`, by default the one for
    this plane), its plain twin on CPU tensors."""
    if seed.device.type == "cpu":
        return fused_level_batched_plain(seed, k, spec, diffusivity, first_level)
    _build.require_cuda(seed, "fused_level")
    _check_planes(seed, "fused_level")
    if k.dtype != torch.float32 or k.shape != seed.shape[:1] or k.device != seed.device:
        raise ValueError("fused_level: k must be a float32 (B,) tensor on the seed's device")
    k = k.contiguous()
    B, h, w = seed.shape
    plan = specs_plan((spec,), h, w, first_level, B, _sms(seed)) if plan is None else plan
    lt, lx, ly, ldet = (torch.empty_like(seed) for _ in range(4))
    lsmooth = _lsmooth_scratch(plan, seed, first_level)
    half_taus = [float(np.float32(0.5 * t)) for t in spec.taus]
    _, smooth = scharr_kernels(spec.sigma_size)
    g1 = gaussian_kernel(1.0)
    _, s1 = scharr_kernels(1)
    counts, table = _plan_table(plan)
    launched = _I(0)
    fn = _build.function("fed", "fused_level", [
        _P, _P, _P, _P, _P, _P,  # seed, k, lt, lx, ly, ldet
        _P,  # scratch: lsmooth
        _I, _I, _I, _I, _I, _I, _FP,  # B, h, w, first, kind, sweeps, half taus
        _I, _F, _F, _FP, _I, _F, _F,  # Scharr size and taps, G_1 taps, sigma-1 Scharr taps
        _IP, _I, _IP, _P,  # plan, its launches, launches made, stream
    ])
    with torch.cuda.device(seed.device):
        err = fn(seed.data_ptr(), k.data_ptr(), lt.data_ptr(), lx.data_ptr(), ly.data_ptr(), ldet.data_ptr(),
                 None if lsmooth is None else lsmooth.data_ptr(),
                 B, h, w, int(first_level), _DIFFUSIVITY_CODE[diffusivity],
                 len(half_taus), (_F * max(1, len(half_taus)))(*half_taus),
                 spec.sigma_size, float(smooth[0]), float(smooth[len(smooth) // 2]),
                 (_F * len(g1))(*g1), len(g1), float(s1[0]), float(s1[1]),
                 table, counts[0], ctypes.byref(launched), _build.stream_of(seed))
    _build.check("fed", err, "fused_level")
    _build.launches["fused_level"] += 1
    device_launches["fused_level"] += launched.value
    return lt, lx, ly, ldet


def build_scale_space_levels(imgs: torch.Tensor, statics, plain: bool = False) -> dict:
    """The per-level scale space of (B, H, W) frames (the JAX package's
    per-level `build_scale_space`) through kernel 1, the contrast factor and
    one kernel 5 launch per level: padded frame-major (B, L, H0, W0) stacks
    "Lt", "Lx", "Ly", "Ldet" with zeros outside each level.  plain=True
    runs the plain twins on any device: the plain per-level build."""
    config: AkazeConfig = statics.config
    specs = statics.specs
    base = base_stage_plain if plain else base_stage
    level = fused_level_batched_plain if plain else fused_level_batched
    seed, modg = base(imgs, float(config.base_scale_offset))
    with span("frontend.contrast", imgs.device):
        k = contrast_factor_from_modg(modg, config)
    B, L = imgs.shape[0], len(specs)
    stacks = {key: imgs.new_zeros((B, L, statics.h0, statics.w0)) for key in ("Lt", "Lx", "Ly", "Ldet")}
    for i, spec in enumerate(specs):
        if i > 0 and spec.octave > specs[i - 1].octave:
            seed = half_size(seed)
            k = k * config.contrast_octave_decay
        outs = level(seed.contiguous(), k, spec, config.diffusivity, i == 0)
        for key, out in zip(("Lt", "Lx", "Ly", "Ldet"), outs):
            stacks[key][:, i, : spec.height, : spec.width] = out
        seed = outs[0]
    return stacks


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
    with span("frontend.contrast", imgs.device):
        k = contrast_factor_from_modg(modg, config)
    groups = statics.groups
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
