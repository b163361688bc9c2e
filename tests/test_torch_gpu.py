"""The port's seven CUDA kernels against their plain PyTorch twins on the
card, the three paths (batched extract + match, the same with the chunked
describe, the per-level extract_fn) and the video front end through the
kernels against the same through the twins, the two-view pose on the
card against the CPU and the reference bound, and the SfM stack (bundle
adjustment, PnP, pose graph, a whole run) on the card against the CPU and
against itself (bit-equal reruns); two ranks sharing the card (gloo)
running the sharded BA and the data-parallel extract; and the degenerate
inputs (chip_smoke.py phase 10a's images through the kernels against the
twins, with the JAX package's counts) and NaN correspondences into the
two-view RANSAC (the card against the CPU).  Every test needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig, RansacConfig, SfmConfig
from akaze_tpu_torch.frontend.describe import describe_batched
from akaze_tpu_torch.frontend.detect import detect, detect_dense, find_candidates_oct
from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch, extract_batch_fn, extract_fn
from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg, half_size
from akaze_tpu_torch.kernels import _build, fed
from akaze_tpu_torch.kernels.describe import describe, describe_plain
from akaze_tpu_torch.kernels.describe_single import describe_pallas, describe_pallas_plain
from akaze_tpu_torch.kernels.fed import (
    base_stage, base_stage_plain, build_scale_space, build_scale_space_levels, fused_level_batched,
    SMALL_TILE, fused_level_batched_plain, fused_octave, fused_octave_plain, level_plan,
    plan_launches, unpack_sub,
)
from akaze_tpu_torch.kernels.patch import gather_patches, gather_patches_plain
from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain
from akaze_tpu_torch.geometry.twoview import estimate_relative_pose, estimate_relative_pose_fn, normalize_points
from akaze_tpu_torch.interop import jax_uniform
from akaze_tpu_torch.matching.hamming import match_features, match_fn
from akaze_tpu_torch.matching.video import extract_frames, process_video_fn, select_keyframes
from akaze_tpu_torch import interop
from akaze_tpu_torch.cli import sfm as cli_sfm
from akaze_tpu_torch.sfm import ba as sfm_ba
from akaze_tpu_torch.sfm.incremental import refine_pose_pnp, run_incremental
from akaze_tpu_torch.sfm.metrics import ate_rmse, camera_centers
from akaze_tpu_torch.sfm.pose_graph import PoseGraph, optimize_pose_graph, relative
from akaze_tpu_torch.utils.synthetic import multi_plane_pair, sfm_scene, video_sequence
from torch_port_helpers import (  # noqa: F401 (cuda: a fixture)
    MATCH_CASES, ROT_BOUND_DEG, TDIR_BOUND_DEG, assert_same_pose, cuda, custom_plan, match_case,
    match_descriptors, pair_keypoints, rot_deg, tdir_err_deg, run_ranks, trajectory_problem,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu

H, W = 240, 320
# 97 x 131 leaves ragged tiles in every kernel and odd octave sizes (the
# half-size drops a trailing row and column).
SIZES = [(240, 320), (97, 131)]


def _frames(cuda, n=3, seed=4, size=(H, W)):
    return torch.from_numpy(video_sequence(n, *size, seed=seed)).to(cuda)


def _plain_octaves(imgs, ss):
    cfg = ss.config
    seed, modg = base_stage_plain(imgs, cfg.base_scale_offset)
    k = contrast_factor_from_modg(modg, cfg)
    args = []
    groups = ss.groups
    outs = []
    for oi, (l0, n, _, _) in enumerate(groups):
        if oi:
            k = k * cfg.contrast_octave_decay
        a = (seed, k, tuple(ss.specs[l0 : l0 + n]), cfg.diffusivity, oi == 0,
             float(cfg.detector_threshold), oi + 1 < len(groups))
        out = fused_octave_plain(*a)
        args.append(a)
        outs.append(out)
        seed = out[5]
    return args, outs


@pytest.mark.parametrize("size", [*SIZES, (480, 640), (5, 7)])
def test_base_stage_kernel(cuda, size):
    """Kernel 1 bit for bit: ragged tiles, a VGA frame and a frame smaller
    than one tile (cut from a larger scene); sigma0 1.6 (9 taps) and 0.05
    (one tap: the others underflow to zero)."""
    h, w = size
    imgs = _frames(cuda, size=(max(h, 120), max(w, 160)))[:, :h, :w].contiguous()
    for sigma0 in (1.6, 0.05):
        n0 = _build.launches["base_stage"]
        got = base_stage(imgs, sigma0)
        assert _build.launches["base_stage"] == n0 + 1
        for g, r in zip(got, base_stage_plain(imgs, sigma0)):
            assert torch.equal(g, r)


def _check_octave(got, ref):
    """The scale-space gates for kernel 2 against its twin."""
    for g, r in zip(got[:3], ref[:3]):
        assert (g - r).abs().max().item() <= 2e-5
    cand = ref[3] > -1e38
    assert torch.equal(cand, got[3] > -1e38)
    assert torch.allclose(got[3], ref[3], atol=2e-6, rtol=1e-6)
    oxg, oyg, kg = unpack_sub(got[4])
    oxr, oyr, kr = unpack_sub(ref[4])
    assert torch.equal(kg[cand], kr[cand])
    both = cand & kg
    assert torch.allclose(oxg[both], oxr[both], atol=1e-4)
    assert torch.allclose(oyg[both], oyr[both], atol=1e-4)
    if ref[5] is not None:
        assert (got[5] - ref[5]).abs().max().item() <= 2e-5


def _octave_plan(a, batch=None):
    """level_plan of kernel 2's arguments a, for their batch or another."""
    seed, _, specs, _, first, _, _ = a
    B, h, w = seed.shape
    sms = torch.cuda.get_device_properties(seed.device).multi_processor_count
    return level_plan(h, w, [len(s.taus) for s in specs], [s.sigma_size for s in specs], first,
                      batch or B, sms)


@pytest.mark.parametrize("diff", list(Diffusivity))
@pytest.mark.parametrize("size", SIZES)
def test_fused_octave_kernel(cuda, size, diff):
    """Kernel 2 on every octave under its default plan; the wrapper reports
    the plan's __global__ launches."""
    ss, _ = _statics(size[1], size[0], AkazeConfig(diffusivity=diff))
    args, outs = _plain_octaves(_frames(cuda, size=size), ss)
    for a, ref in zip(args, outs):
        plan, with_half = _octave_plan(a), a[-1]
        n0 = fed.device_launches["fused_octave"]
        got = fused_octave(*a)
        assert fed.device_launches["fused_octave"] - n0 == plan_launches(plan, with_half) <= 10
        _check_octave(got, ref)


# Plans the default schedule does not take for three frames: fused level
# launches on small ragged tiles, the plan of a batch of 128 (whole planes
# wherever they fit; at 240x320 octave 0 runs tiled and octave 1 on whole
# planes), and every level's detect cascade in a launch of its own.
OTHER_PLANS = ("ragged tiles", "whole planes", "separate detect")


def _other_plan(a, variant):
    seed, _, specs, _, first, _, _ = a
    h, w = seed.shape[-2:]
    if variant == "whole planes":
        return _octave_plan(a, batch=128)
    ragged = variant == "ragged tiles"
    return custom_plan(specs, h, w, first, (16, 24) if ragged else SMALL_TILE, ragged)


@pytest.mark.parametrize("variant", OTHER_PLANS)
@pytest.mark.parametrize("diff", list(Diffusivity))
@pytest.mark.parametrize("size", SIZES)
def test_level_chain_kernels_on_other_plans(cuda, size, diff, variant):
    """Kernels 2 and 5 on plans other than their default."""
    ss, _ = _statics(size[1], size[0], AkazeConfig(diffusivity=diff))
    args, outs = _plain_octaves(_frames(cuda, size=size), ss)
    schedules = []
    for a, ref in zip(args[:2], outs[:2]):
        seed, k, specs, _, first, _, with_half = a
        plan = _other_plan(a, variant)
        schedules.append({p.schedule for p in plan[1 if first else 0 :]})
        n0 = fed.device_launches["fused_octave"]
        _check_octave(fused_octave(*a, plan=plan), ref)
        assert fed.device_launches["fused_octave"] - n0 == plan_launches(plan, with_half)
        for li, spec in enumerate(specs):
            src = seed if li == 0 else ref[0][li - 1]
            got = fused_level_batched(src, k, spec, diff, first and li == 0, plan=plan[li : li + 1])
            for g, r in zip(got, fused_level_batched_plain(src, k, spec, diff, first and li == 0)):
                assert (g - r).abs().max().item() <= 2e-5
    stages = {l.stage for a in args[:2] for p in _other_plan(a, variant) for l in p.launches}
    if variant == "ragged tiles":
        assert "level" in stages and "diffuse" not in stages
    elif variant == "separate detect":
        assert "level" not in stages
    elif size == (240, 320):
        assert schedules == [{"tiled"}, {"plane"}]


def _describe_scene(cuda):
    ss, ds = _statics(W, H, AkazeConfig())
    _, outs = _plain_octaves(_frames(cuda), ss)
    lvl_oct = tuple({"Lt": o[0], "Lx": o[1], "Ly": o[2]} for o in outs)
    fields = tuple({"score": o[3], "sub": o[4]} for o in outs)
    return ss, ds, lvl_oct, detect(find_candidates_oct(fields, ss), fields, ss)


def test_describe_kernel(cuda):
    """Kernel 3 bit for bit, angles and descriptors, with holes inside the
    valid prefix."""
    ss, ds, lvl_oct, kps = _describe_scene(cuda)
    kps.valid[0, 3:12] = False
    n0 = _build.launches["describe"]
    ang_k, desc_k = describe(kps, lvl_oct, ss, ds)
    assert _build.launches["describe"] == n0 + 1
    ang_p, desc_p = describe_plain(kps, lvl_oct, ss, ds)
    v = kps.valid
    assert int(v.sum()) > 100
    assert torch.equal(ang_k, ang_p) and torch.equal(desc_k, desc_p)
    assert (desc_k[~v] == 0).all() and (ang_k[~v] == 0).all()


@pytest.mark.parametrize("case", ["all dead", "ragged slots", "two rounds"])
def test_describe_kernel_walk(cuda, case):
    """Kernel 3's persistent walk: a batch with no valid slot; 3 x 1,000
    slots (not a multiple of the grid or of a block's 128-slot round); 140
    frames (143,360 slots: more than one round of 128 per block on a card's
    resident grid)."""
    ss, ds, lvl_oct, kps = _describe_scene(cuda)
    if case == "all dead":
        kps.valid[:] = False
    elif case == "ragged slots":
        kps = dataclasses.replace(kps, **{f.name: getattr(kps, f.name)[:, :1000].contiguous()
                                          for f in dataclasses.fields(kps)})
    else:
        frames = torch.arange(140, device=cuda) % 3
        kps = dataclasses.replace(kps, **{f.name: getattr(kps, f.name)[frames].contiguous()
                                          for f in dataclasses.fields(kps)})
        lvl_oct = tuple({k: v[:, frames].contiguous() for k, v in o.items()} for o in lvl_oct)
    ang_k, desc_k = describe(kps, lvl_oct, ss, ds)
    ang_p, desc_p = describe_plain(kps, lvl_oct, ss, ds)
    assert torch.equal(ang_k, ang_p) and torch.equal(desc_k, desc_p)
    if case == "all dead":
        assert (desc_k == 0).all() and (ang_k == 0).all()


def _match_inputs(cuda, case):
    """(da, va, db, vb) on the card: one of MATCH_CASES as one pair, or
    "main path": 127 consecutive pairs of 1,024 slots whose valid slots are
    a prefix with holes (~210 per frame), near-duplicates between frames."""
    if case != "main path":
        a, va, b, vb = match_case(*case)
        return tuple(torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)[None].to(cuda)
                     for x in (a, va, b, vb))
    rng = np.random.default_rng(12)
    d = match_descriptors(rng, 128 * 1024).reshape(128, 1024, 16)
    flips = np.uint32(1) << rng.integers(0, 32, size=(127, 300, 16), dtype=np.uint32)
    d[1:, :300] = d[:-1, :300] ^ (flips * (rng.random((127, 300, 16)) < 0.05))
    d[:, 700:720] = d[:, :20]  # duplicate slots: ties
    v = np.arange(1024)[None, :] < rng.integers(150, 280, size=(128, 1))
    v[:, 4::9] = False
    dt, vt = torch.from_numpy(d.view(np.int32)).to(cuda), torch.from_numpy(v).to(cuda)
    return dt[:-1].contiguous(), vt[:-1].contiguous(), dt[1:].contiguous(), vt[1:].contiguous()


@pytest.mark.parametrize("case", [*MATCH_CASES, "main path"])
def test_match_kernel(cuda, case):
    """Kernel 4 exactly equal to its twin on all five vectors: ragged tiles,
    ties across every boundary of its decomposition, all-invalid sides, and
    the main path's 127 pairs of 1,024 slots."""
    da, va, db, vb = _match_inputs(cuda, case)
    n0 = _build.launches["match"]
    got = match_reduce(da, va, db, vb)
    assert _build.launches["match"] == n0 + 1
    for name, g, r in zip(("best", "second", "nn", "colmin", "colarg"), got, match_reduce_plain(da, va, db, vb)):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("size", SIZES)
def test_whole_path_kernels_vs_plain(cuda, size):
    frames = _frames(cuda, n=2, seed=7, size=size)
    fk = extract_batch(frames, device=cuda)
    fp = extract_batch_fn(frames, AkazeConfig(), plain=True)
    for f in range(2):
        to_np = lambda feats: {**{k: getattr(feats.keypoints, k)[f].cpu().numpy()
                                  for k in ("x", "y", "class_id", "valid")},
                               "descriptors": feats.descriptors[f].cpu().numpy()}
        frac, hams = pair_keypoints(to_np(fp), to_np(fk))
        assert frac >= 0.98 and hams.mean() <= 3
    cfg = MatchConfig()
    mk = match_fn(fk.descriptors[:1], fk.keypoints.valid[:1], fk.descriptors[1:], fk.keypoints.valid[1:], cfg)
    mp = match_fn(fp.descriptors[:1], fp.keypoints.valid[:1], fp.descriptors[1:], fp.keypoints.valid[1:], cfg,
                  plain=True)
    assert abs(int(mk.count().sum()) - int(mp.count().sum())) <= 0.05 * int(mp.count().sum())


def test_flat_frames_through_the_kernels(cuda):
    """No keypoint anywhere: every describe slot and every match row takes
    its invalid branch."""
    frames = torch.full((2, 97, 131), 0.5, device=cuda)
    feats = extract_batch(frames, device=cuda)
    assert int(feats.keypoints.count().sum()) == 0
    assert (feats.descriptors == 0).all() and (feats.keypoints.angle == 0).all()
    m = match_fn(feats.descriptors[:1], feats.keypoints.valid[:1], feats.descriptors[1:],
                 feats.keypoints.valid[1:], MatchConfig())
    assert not m.accepted.any() and (m.distance == 1 << 30).all() and (m.idx_b == 0).all()


@pytest.mark.parametrize("diff", list(Diffusivity))
@pytest.mark.parametrize("size", SIZES)
def test_fused_level_kernel(cuda, size, diff):
    """Kernel 5 on every level of the per-level build, each fed the plain
    chain's seed."""
    cfg = AkazeConfig(diffusivity=diff)
    ss, _ = _statics(size[1], size[0], cfg)
    seed, modg = base_stage_plain(_frames(cuda, size=size), cfg.base_scale_offset)
    k = contrast_factor_from_modg(modg, cfg)
    n0 = _build.launches["fused_level"]
    d0 = fed.device_launches["fused_level"]
    planned = 0
    for i, spec in enumerate(ss.specs):
        if i > 0 and spec.octave > ss.specs[i - 1].octave:
            seed, k = half_size(seed).contiguous(), k * cfg.contrast_octave_decay
        got = fused_level_batched(seed, k, spec, diff, i == 0)
        ref = fused_level_batched_plain(seed, k, spec, diff, i == 0)
        for g, r in zip(got, ref):
            assert (g - r).abs().max().item() <= 2e-5
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        planned += plan_launches(level_plan(*seed.shape[-2:], [len(spec.taus)], [spec.sigma_size], i == 0,
                                            seed.shape[0], sms))
        seed = ref[0]
    assert _build.launches["fused_level"] == n0 + ss.num_levels
    # At most two launches a level (one where the detect cascade is fused).
    assert fed.device_launches["fused_level"] - d0 == planned <= 2 * ss.num_levels - 1


# A lower detector threshold keeps a few dozen keypoints per frame at the
# odd size too.
LEVEL_CFG = AkazeConfig(detector_threshold=3e-4)


def _level_scene(cuda, size, n=2, seed=5):
    ss, ds = _statics(size[1], size[0], LEVEL_CFG)
    st = build_scale_space_levels(_frames(cuda, n=n, seed=seed, size=size), ss, plain=True)
    return ss, ds, st


@pytest.mark.parametrize("size", SIZES)
def test_describe_pallas_kernel(cuda, size):
    ss, ds, st = _level_scene(cuda, size)
    kps = detect_dense(st["Ldet"], ss)
    for f in range(2):
        kp = kps.index(f)
        assert int(kp.valid.sum()) > 20
        kp.valid[2:6] = False  # holes inside the valid prefix
        stacks = {k: st[k][f].contiguous() for k in ("Lt", "Lx", "Ly")}
        ang_k, desc_k = describe_pallas(kp, stacks, ss, ds)
        ang_p, desc_p = describe_pallas_plain(kp, stacks, ss, ds)
        v = kp.valid
        assert torch.equal(ang_k, ang_p) and torch.equal(desc_k, desc_p)
        assert (desc_k[~v] == 0).all() and (ang_k[~v] == 0).all()


@pytest.mark.parametrize("size", SIZES)
def test_gather_patches_kernel(cuda, size):
    """Kernel 7 on the three stack layouts, any slot count, bit for bit."""
    ss, ds, st = _level_scene(cuda, size, n=3)
    rng = np.random.default_rng(11)
    N = 301
    t = lambda a: torch.from_numpy(a).to(cuda)
    frame, lvl = t(rng.integers(0, 3, N)), t(rng.integers(0, ss.num_levels, N))
    y0 = t(rng.integers(-5, ss.h0, N))
    x0 = t(rng.integers(-5, ss.w0, N))
    valid = t(rng.random(N) < 0.8)
    frame_major = {k: st[k] for k in ("Lt", "Lx", "Ly")}
    level_major = {**{k: st[k].transpose(0, 1).contiguous() for k in ("Lt", "Lx", "Ly")}, "level_major": True}
    single = {k: st[k][1].contiguous() for k in ("Lt", "Lx", "Ly")}
    for stacks in (frame_major, level_major, single):
        got = gather_patches(stacks, frame, lvl, y0, x0, valid, ds.ph, ds.pw)
        assert torch.equal(got, gather_patches_plain(stacks, frame, lvl, y0, x0, valid, ds.ph, ds.pw))
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("size", SIZES)
def test_chunked_describe_path_kernels_vs_plain(cuda, size):
    frames = _frames(cuda, n=2, seed=7, size=size)
    cfg = AkazeConfig(describe_backend="xla")
    n0 = dict(_build.launches)
    fk = extract_batch(frames, cfg, device=cuda)
    assert _build.launches["gather_patches"] > n0["gather_patches"]
    assert _build.launches["describe"] == n0["describe"]
    fp = extract_batch_fn(frames, cfg, plain=True)
    assert torch.equal(fk.keypoints.valid, fp.keypoints.valid)
    assert torch.equal(fk.descriptors, fp.descriptors)
    assert torch.equal(fk.keypoints.angle, fp.keypoints.angle)


@pytest.mark.parametrize("size", SIZES)
def test_per_level_path_kernels_vs_plain(cuda, size):
    img = _frames(cuda, n=1, seed=8, size=size)[0]
    n0 = dict(_build.launches)
    fk = extract_fn(img, LEVEL_CFG)
    for name in ("base_stage", "fused_level", "gather_patches"):
        assert _build.launches[name] > n0[name], name
    fp = extract_fn(img, LEVEL_CFG, plain=True)
    assert int(fk.keypoints.count()) > 20
    assert torch.equal(fk.keypoints.valid, fp.keypoints.valid)
    assert torch.equal(fk.keypoints.x, fp.keypoints.x) and torch.equal(fk.keypoints.y, fp.keypoints.y)
    assert torch.equal(fk.descriptors, fp.descriptors)


def test_video_kernels_vs_plain(cuda):
    """12 VGA frames at batch 5 (chunks of 5, 5 and a tail of 2): through
    kernels 1-4 and through the twins, exactly equal."""
    frames = _frames(cuda, n=12, seed=6, size=(480, 640))
    args = (AkazeConfig(), MatchConfig(max_distance=120), SfmConfig())
    n0 = dict(_build.launches)
    got = process_video_fn(frames, *args, batch=5)
    n = {k: _build.launches[k] - n0[k] for k in n0}
    assert n["base_stage"] == n["describe"] == 3 and n["fused_octave"] == 12
    assert n["match"] == 1 + 11  # the consecutive pairs, then one per frame of the keyframe loop
    ref = process_video_fn(frames, *args, batch=5, plain=True)
    assert got.keyframes == ref.keyframes
    np.testing.assert_array_equal(got.match_counts, ref.match_counts)
    np.testing.assert_array_equal(got.kf_match_counts, ref.kf_match_counts)
    for name in ("idx_b", "distance", "accepted"):
        assert torch.equal(getattr(got.matches_prev, name), getattr(ref.matches_prev, name)), name
    assert (got.match_counts[1:] > 100).all()


def test_keyframe_loop_issues_no_host_sync(cuda):
    frames = torch.cat([_frames(cuda, n=4, seed=5), _frames(cuda, n=4, seed=99).flip(1, 2)])
    feats = extract_frames(frames, AkazeConfig(), batch=8)
    mcfg, scfg = MatchConfig(max_distance=120), SfmConfig(keyframe_min_tracked=0.7)
    select_keyframes(feats.index(slice(0, 2)), mcfg, scfg)  # loads kernel 4's library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts, flags = select_keyframes(feats, mcfg, scfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref_counts, ref_flags = select_keyframes(feats, mcfg, scfg, plain=True)
    assert torch.equal(counts, ref_counts) and torch.equal(flags, ref_flags)
    assert bool(flags[4])  # the scene cut


def test_batch_path_after_the_scale_space_issues_no_host_sync(cuda):
    """Candidates, detect and the fused describe of a VGA batch make no host
    sync once the statics' device tables exist (the scale space, contrast
    factor included, is held to the same in tests/test_torch_contrast.py)."""
    frames = _frames(cuda, n=4, seed=8, size=(480, 640))
    ss, ds = _statics(640, 480, AkazeConfig())
    st = build_scale_space(frames, ss)

    def after_scale_space():
        kps = detect(find_candidates_oct(st["oct"], ss), st["oct"], ss)
        return describe_batched(kps, st["lvl_oct"], ss, ds)

    want = after_scale_space()  # warms the path up: libraries, device tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = after_scale_space()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.descriptors, want.descriptors) and int(got.keypoints.valid.sum()) > 100


def _plane_correspondences(cuda, seed):
    img_a, img_b, R_gt, t_gt, intr = multi_plane_pair(seed=seed)
    feats = extract_batch(np.stack([img_a, img_b]), device=cuda)
    m = match_features(feats.index(0), feats.index(1), device=cuda)
    kp = feats.keypoints
    x1 = normalize_points(kp.x[0], kp.y[0], intr)
    x2 = normalize_points(kp.x[1][m.idx_b.long()], kp.y[1][m.idx_b.long()], intr)
    return x1, x2, m.accepted, R_gt, t_gt


@pytest.mark.parametrize("seed", [5, 6])
def test_two_view_card_matches_cpu(cuda, seed):
    """The card's RANSAC against the port's CPU RANSAC on the same
    correspondences and the same random scores."""
    x1, x2, mask, _, _ = _plane_correspondences(cuda, seed)
    cfg = RansacConfig(num_iterations=512, inlier_threshold=2e-3)
    g = torch.rand((cfg.num_iterations, mask.shape[0]), generator=torch.Generator(device=cuda).manual_seed(seed),
                   device=cuda)
    card = estimate_relative_pose_fn(x1, x2, mask, cfg, sample_scores=g)
    cpu = estimate_relative_pose_fn(x1.cpu(), x2.cpu(), mask.cpu(), cfg, sample_scores=g.cpu())
    assert_same_pose(cpu, card)


@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_two_view_within_reference_bound_on_card(cuda, seed):
    """tests/test_two_view_bound.py's gate on the card, on that test's
    random scores (jax.random.uniform(PRNGKey(0)), reproduced by
    interop.jax_uniform): the bound was set on those draws, and other draws
    miss it on some scenes in the reference too."""
    x1, x2, mask, R_gt, t_gt = _plane_correspondences(cuda, seed)
    cfg = RansacConfig(num_iterations=512, inlier_threshold=2e-3)
    g = jax_uniform(cfg.seed, (cfg.num_iterations, mask.shape[0]))
    res = estimate_relative_pose(x1, x2, mask, cfg, device=cuda, sample_scores=g)
    assert rot_deg(res.R.cpu().numpy(), R_gt) <= ROT_BOUND_DEG
    assert tdir_err_deg(res.t.cpu().numpy(), t_gt) <= TDIR_BOUND_DEG
    assert int(res.num_inliers) >= 30


# ---------------------------------------------------------------- SfM


@pytest.mark.parametrize("K, P", [(12, 128), (72, 320)])
def test_bundle_adjust_card_matches_cpu(cuda, K, P):
    """The dense solve (K <= 64) and the CG (K > 64) on the card against the
    CPU twin: poses within 1e-4, points within 1e-4 of their distance (see
    tests/test_torch_ba.py), the same rmse within 1e-6."""
    fields, gt = trajectory_problem(K=K, P=P)
    cfg = SfmConfig(ba_iterations=8)
    card = sfm_ba.bundle_adjust(interop.ba_problem_from_numpy(fields, device=cuda), cfg)
    cpu = sfm_ba.bundle_adjust(interop.ba_problem_from_numpy(fields, device="cpu"), cfg)
    np.testing.assert_allclose(card.poses.cpu().numpy(), cpu.poses.numpy(), atol=1e-4, rtol=0)
    pts = cpu.points.numpy()
    scale = np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1.0)
    assert (np.abs(card.points.cpu().numpy() - pts) / scale).max() < 1e-4
    assert abs(float(sfm_ba.reprojection_rmse(card)) - float(sfm_ba.reprojection_rmse(cpu))) < 1e-6
    assert float(sfm_ba.reprojection_rmse(card)) < 2e-3 and np.abs(card.poses.cpu().numpy() - gt).max() < 0.1


def test_refine_pose_pnp_card_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    pts = rng.uniform([-2, -2, 5], [2, 2, 10], (64, 3)).astype(np.float32)
    gt = np.array([0.1, -0.05, 0.02, 0.3, -0.1, 0.2], np.float32)
    poses = torch.from_numpy(np.repeat(gt[None], 64, axis=0))
    uv = sfm_ba.project(poses, torch.from_numpy(pts), torch.zeros(64, 2), jacobians=False).numpy()
    uv = uv + rng.normal(0, 1e-3, uv.shape).astype(np.float32)
    valid = np.ones(64, np.float32)
    valid[-4:] = 0.0
    args = [np.zeros(6, np.float32), pts, uv, valid]
    card = refine_pose_pnp(*(torch.from_numpy(a).to(cuda) for a in args)).cpu().numpy()
    cpu = refine_pose_pnp(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(card, cpu, atol=1e-5, rtol=0)
    assert np.abs(card - gt).max() < 5e-3


def test_pose_graph_card_matches_cpu(cuda):
    gt, _, closures = sfm_scene(40, 10, seed=1, loop=True, num_closures=2)
    rng = np.random.default_rng(2)
    init = (gt + np.cumsum(rng.normal(0, 2e-3, gt.shape), axis=0)).astype(np.float32)
    init[0] = gt[0]
    gt_t = torch.from_numpy(gt)
    ei = list(range(1, 40)) + [j for _, j, _ in closures]
    ej = list(range(39)) + [i for i, _, _ in closures]
    rel = relative(gt_t[ei], gt_t[ej]).numpy()
    fixed = np.zeros(40, bool)
    fixed[0] = True

    def graph(dev):
        return PoseGraph(poses=torch.from_numpy(init).to(dev), edge_i=torch.tensor(ei, device=dev),
                         edge_j=torch.tensor(ej, device=dev), rel=torch.from_numpy(rel).to(dev),
                         valid=torch.ones(len(ei), dtype=torch.bool, device=dev),
                         fixed=torch.from_numpy(fixed).to(dev))
    card = optimize_pose_graph(graph(cuda), iterations=12).poses.cpu().numpy()
    cpu = optimize_pose_graph(graph("cpu"), iterations=12).poses.numpy()
    np.testing.assert_allclose(card, cpu, atol=1e-4, rtol=0)
    assert np.abs(card - gt).max() < np.abs(init - gt).max()


def test_sfm_on_card_is_deterministic_and_matches_cpu(cuda):
    """A loop scene past K = 64 (the CG and the pose graph) twice on the
    card: bit-equal poses and points.  The CPU twin, on the same random
    draws: within 1 % of the card's valid points (float32 sums in another
    order move a few points across the triangulation gates), camera centers
    within 1e-2 after the first window and 0.1 at the end, and both ATEs
    against the ground truth under 0.5.  Seen on the H100: 0.0041 and 0.040
    apart, ATE 0.359 and 0.364; this short loop drifts in both packages
    (its monocular scale is weakly held), which the 200-keyframe scene of
    chip_smoke.py does not."""
    gt, obs, closures = sfm_scene(72, 900, seed=0, loop=True, obs_noise=5e-4)
    kw = dict(sconfig=SfmConfig(ba_iterations=4), rconfig=RansacConfig(num_iterations=128, inlier_threshold=5e-3),
              ba_every=8, closures=closures, draws=jax_uniform)
    first = {}

    def keep_first(name):
        return lambda k, poses, _: first.setdefault(name, poses[: k + 1].copy())

    a = run_incremental(obs, 72, device=cuda, on_window=keep_first("card"), **kw)
    b = run_incremental(obs, 72, device=cuda, **kw)
    assert np.array_equal(a.poses, b.poses) and np.array_equal(a.points, b.points)
    cpu = run_incremental(obs, 72, device="cpu", on_window=keep_first("cpu"), **kw)
    assert abs(len(cpu.track_point) - len(a.track_point)) <= 0.01 * len(cpu.track_point)
    assert np.isfinite(a.poses).all() and np.isfinite(a.points).all()
    assert np.abs(camera_centers(first["card"]) - camera_centers(first["cpu"])).max() < 1e-2
    assert np.abs(camera_centers(a.poses) - camera_centers(cpu.poses)).max() < 0.1
    truth = camera_centers(gt)
    assert ate_rmse(camera_centers(a.poses), truth) < 0.5 and ate_rmse(camera_centers(cpu.poses), truth) < 0.5


def test_cli_sfm_refuses_mesh_on_card(cuda, tmp_path, capsys):
    """--mesh 2 in a world of one process is refused; run_incremental takes
    only a parallel mesh."""
    np.save(tmp_path / "fr.npy", video_sequence(2, 96, 128, seed=5))
    with pytest.raises(SystemExit) as e:
        cli_sfm.main([str(tmp_path / "fr.npy"), "-o", str(tmp_path / "s.json"), "--mesh", "2", "--device", "cuda"])
    assert e.value.code == 2 and "torch.distributed.run --nproc-per-node 2" in capsys.readouterr().err
    with pytest.raises(TypeError, match="Mesh"):
        run_incremental([], 2, mesh=object(), device=cuda)


def test_two_ranks_share_the_card_for_sharded_ba(cuda, tmp_path):
    """2 rank processes on one card (gloo): the sharded BA within 5e-4 of
    bundle_adjust on the card, two runs bit-equal."""
    fields = trajectory_problem(K=12, P=64, Q=4)[0]
    got = run_ranks("ba", 2, tmp_path, fields, {"iterations": 6, "device": "cuda"}, timeout=300)
    assert bool(got["rerun_equal"])
    single = sfm_ba.bundle_adjust(interop.ba_problem_from_numpy(fields, device=cuda), SfmConfig(ba_iterations=6))
    np.testing.assert_allclose(got["poses"], single.poses.cpu().numpy(), atol=5e-4, rtol=0)


def test_two_ranks_share_the_card_for_dp_extract(cuda, tmp_path):
    """2 rank processes on one card: the gathered features of the sharded
    batch equal extract_batch's on the card bit for bit."""
    _build.build()  # once here, not in each rank
    frames = video_sequence(8, H, W, seed=4)
    cfg = dict(max_keypoints=256)
    got = run_ranks("extract", 2, tmp_path, {"frames": frames}, {"config": cfg, "device": "cuda"}, timeout=300)
    want = interop.features_to_numpy(extract_batch(frames, AkazeConfig(**cfg), device=cuda))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(got["total_valid"]) == int(want["valid"].sum()) > 0


# ------------------------------------------------------------------ oracles and conductivity variants


@pytest.mark.parametrize("diff", [Diffusivity.PM_G1, Diffusivity.WEICKERT])
@pytest.mark.parametrize("size", SIZES)
def test_conductivity_variants_bit_equal(cuda, size, diff):
    """Kernels 2 and 5 with conductivity kinds 0 (g1) and 2 (Weickert) bit
    for bit against their twins: the twin takes Weickert's exponent as a
    true division, as the kernel does (torch's `scalar / tensor` is a
    reciprocal and a product, which rounds otherwise)."""
    ss, _ = _statics(size[1], size[0], AkazeConfig(diffusivity=diff))
    args, outs = _plain_octaves(_frames(cuda, size=size), ss)
    for a, ref in zip(args, outs):
        got = fused_octave(*a)
        for g, r in zip(got, ref):
            assert (g is None and r is None) or torch.equal(g, r)
    cfg = ss.config
    seed, modg = base_stage_plain(_frames(cuda, size=size), cfg.base_scale_offset)
    k = contrast_factor_from_modg(modg, cfg)
    for i, spec in enumerate(ss.specs):
        if i > 0 and spec.octave > ss.specs[i - 1].octave:
            seed, k = half_size(seed).contiguous(), k * cfg.contrast_octave_decay
        got = fused_level_batched(seed, k, spec, diff, i == 0)
        ref = fused_level_batched_plain(seed, k, spec, diff, i == 0)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        seed = ref[0]


def test_scene_class_on_card_holds_to_snapshot(cuda):
    """The repetitive grid (the densest class, 243 golden keypoints) through
    the kernels against the golden scene snapshot, under
    tests/test_scene_regression.py's gates."""
    from pathlib import Path

    from akaze_tpu_torch.frontend.pipeline import extract
    from akaze_tpu_torch.utils.synthetic import SCENE_CLASSES

    with np.load(Path(__file__).parent / "data" / "golden_scene_snapshots.npz") as z:
        shape, seed = tuple(int(v) for v in z["image_shape"]), int(z["seed"])
        sx, sy, sd = z["repetitive_grid_x"], z["repetitive_grid_y"], z["repetitive_grid_descriptors"]
    got = interop.features_to_numpy(extract(SCENE_CLASSES["repetitive_grid"](*shape, seed=seed), device=cuda))
    v = got["valid"]
    assert abs(int(v.sum()) - len(sx)) <= max(2, 0.1 * len(sx))
    d2 = (got["x"][v][:, None] - sx[None, :]) ** 2 + (got["y"][v][:, None] - sy[None, :]) ** 2
    dmin = np.sqrt(d2.min(1))
    assert (dmin < 0.5).mean() >= 0.9 and (np.sqrt(d2.min(0)) < 0.5).mean() >= 0.9
    ok = dmin < 0.5
    ham = np.bitwise_count(interop.pack_descriptor_bytes(sd)[d2.argmin(1)[ok]] ^ got["descriptors"][v][ok]).sum(1)
    assert np.median(ham) <= 4


@pytest.mark.parametrize("mutual", [True, False])
def test_match_kernel_equals_native_matcher(cuda, mutual):
    """Kernel 4's matcher (`match_fn`) and the native C++ matcher accept the
    same pairs at the same distances on two consecutive frames' valid
    descriptors."""
    from akaze_tpu_torch import native

    if not native.available():
        pytest.skip("g++ unavailable: native library not built")
    feats = extract_batch(_frames(cuda, n=2, seed=8), device=cuda)
    cfg = MatchConfig(mutual=mutual)
    m = match_features(feats.index(0), feats.index(1), cfg, device=cuda)
    arr = interop.features_to_numpy(feats)
    ia, ib = np.nonzero(arr["valid"][0])[0], np.nonzero(arr["valid"][1])[0]
    idx, dist, acc = native.match_hamming_native(arr["descriptors"][0][ia], arr["descriptors"][1][ib],
                                                 ratio=cfg.ratio, mutual=cfg.mutual, max_distance=cfg.max_distance)
    got_acc, got_idx, got_dist = (x.cpu().numpy() for x in (m.accepted, m.idx_b, m.distance))
    want = {(int(ia[i]), int(ib[idx[i]])) for i in np.nonzero(acc)[0]}
    assert {(int(i), int(got_idx[i])) for i in np.nonzero(got_acc)[0]} == want and len(want) > 20
    np.testing.assert_array_equal(got_dist[ia], dist)


# ---------------------------------------------------------------- degenerate inputs


def _same_matches(m, p) -> bool:
    return all(torch.equal(getattr(m, k), getattr(p, k)) for k in ("idx_b", "distance", "accepted"))


@pytest.mark.parametrize("case", list(chip_smoke.DEGENERATE_COUNTS))
def test_degenerate_input_kernels_equal_plain(cuda, case):
    """chip_smoke.py phase 10a's case through kernels 1-4 and through the
    plain twins on the card: equal slot for slot, with the keypoints the
    JAX package finds."""
    img, small = chip_smoke.degenerate_inputs(np, ROOT)[case]
    cfg = AkazeConfig(**chip_smoke.DEGENERATE_SMALL) if small else AkazeConfig()
    got = extract_batch(img[None], cfg, device=cuda)
    ref = extract_batch_fn(torch.from_numpy(img[None]).to(cuda), cfg, plain=True)
    for f in dataclasses.fields(got.keypoints):
        assert torch.equal(getattr(got.keypoints, f.name), getattr(ref.keypoints, f.name)), f.name
    assert torch.equal(got.descriptors, ref.descriptors)
    kp = got.keypoints
    assert int(kp.valid.sum()) == chip_smoke.DEGENERATE_COUNTS[case]
    assert torch.isfinite(kp.x[kp.valid]).all() and torch.isfinite(kp.response[kp.valid]).all()
    d, v = got.descriptors, kp.valid
    assert _same_matches(match_fn(d, v, d, v, MatchConfig()), match_fn(d, v, d, v, MatchConfig(), plain=True))


def test_empty_descriptor_sets_on_card(cuda):
    img, _ = chip_smoke.degenerate_inputs(np, ROOT)["uint8"]
    feats = extract_batch(img[None], AkazeConfig(**chip_smoke.DEGENERATE_SMALL), device=cuda)
    k = chip_smoke.DEGENERATE_SMALL["max_keypoints"]
    sets = {"empty": (torch.zeros((1, k, 16), dtype=torch.int32, device=cuda),
                      torch.zeros((1, k), dtype=torch.bool, device=cuda)),
            "full": (feats.descriptors, feats.keypoints.valid)}
    for a, b in (("empty", "full"), ("full", "empty"), ("empty", "empty")):
        m = match_fn(*sets[a], *sets[b], MatchConfig())
        assert int(m.count().sum()) == 0 and _same_matches(m, match_fn(*sets[a], *sets[b], MatchConfig(), plain=True))


@pytest.mark.parametrize("case", list(chip_smoke.NAN_PAIR_CASES))
def test_nan_pair_card_matches_cpu(cuda, case):
    """Two-view RANSAC with NaN correspondences on the card and on the CPU,
    on JAX's draws: the same inliers as the JAX package, the same pose."""
    rows, keep, want = chip_smoke.NAN_PAIR_CASES[case]
    x1, x2, mask = chip_smoke.nan_pair_inputs(np)
    x1[rows] = np.nan
    mask[rows] = keep
    cfg = RansacConfig(num_iterations=64)
    g = jax_uniform(cfg.seed, (cfg.num_iterations, len(mask)))
    card = estimate_relative_pose(x1, x2, mask, cfg, device=cuda, sample_scores=g)
    cpu = estimate_relative_pose(x1, x2, mask, cfg, device="cpu", sample_scores=g)
    assert int(card.num_inliers) == int(cpu.num_inliers) == want
    if want == 0:
        assert torch.isnan(card.t).all() and torch.isnan(cpu.t).all()
    else:
        assert_same_pose(cpu, card)


def test_fused_octave_nan_seed_equals_plain(cuda):
    """Kernel 2 on a seed with a NaN block (phase 10a's NaN frame, 4 frames
    at 240x320 with the block in frame 1) and the clean frames' contrast
    factor, so the NaN region grows level by level: a pixel beside it
    compares against a NaN neighbour, which no neighbour maximum may drop
    (torch.maximum propagates NaN).  Every octave's fields equal the twin's,
    NaN for NaN."""
    imgs = _frames(cuda, n=4, size=(240, 320))
    ss, _ = _statics(320, 240, AkazeConfig())
    cfg = ss.config
    k = contrast_factor_from_modg(base_stage_plain(imgs, cfg.base_scale_offset)[1], cfg)
    imgs[1, 100:104, 150:154] = float("nan")
    seed, _ = base_stage_plain(imgs, cfg.base_scale_offset)
    groups = ss.groups
    n_nan = 0
    for oi, (l0, n, _, _) in enumerate(groups):
        if oi:
            k = k * cfg.contrast_octave_decay
        a = (seed, k, tuple(ss.specs[l0 : l0 + n]), cfg.diffusivity, oi == 0, float(cfg.detector_threshold),
             oi + 1 < len(groups))
        got, ref = fused_octave(*a), fused_octave_plain(*a)
        for g, r in zip(got, ref):
            if r is not None:
                torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
        n_nan += int(torch.isnan(ref[0]).sum())
        seed = ref[5]
    assert n_nan > 1000
