"""The launch plan of kernels 2 and 5 (`kernels/fed.level_plan`), the tile
semantics of their level chain and of kernel 1, on the CPU.

The CUDA kernels run each level as a few launches over output tiles, each
block loading its input with a halo clipped to the plane and clamping every
neighbour to what it loaded.  `_emulate_level` does the same in PyTorch:
it cuts each tile's extent out of the plane, runs the plain stages on the
extent alone (so they clamp at the extent's border) and keeps the tile.  It
must give the plain chain (`fed_cycle`, `detector_response_level`,
`score_fields_plain`) bit for bit, which holds only if every halo covers
its launch's stages and the plane border is the only border that matters.
Kernel 1 (`base_stage`) runs on the same tiles; `_replay_base_stage` cuts
its tiles and halo the same way.
"""

from types import SimpleNamespace


import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
from akaze_tpu_torch.core.image import gaussian_kernel
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.frontend.scale_space import (
    conductivity, detector_response_level, fed_cycle, gaussian_blur, half_size, scharr,
)
from akaze_tpu_torch.kernels import fed
from akaze_tpu_torch.kernels.fed import (
    BASE_HALO, BASE_TILE, NEG, SMEM_MAX, base_stage_plain, fused_level_batched, fused_level_batched_plain,
    fused_octave, fused_octave_plain, level_plan, plan_launches, score_fields_plain,
)
from akaze_tpu_torch.utils.synthetic import video_sequence
from torch_port_helpers import custom_plan

torch.set_num_threads(2)
H100_SMS = 132


def _octaves(w, h, cfg=None):
    ss, _ = _statics(w, h, cfg or AkazeConfig())
    groups = ss.groups
    return ss, [(oi, ss.specs[l0 : l0 + n], ph, pw) for oi, (l0, n, ph, pw) in enumerate(groups)]


def _plan(specs, h, w, first, batch):
    return level_plan(h, w, [len(s.taus) for s in specs], [s.sigma_size for s in specs], first, batch, H100_SMS)



@pytest.mark.parametrize("size", [(480, 640), (240, 320), (97, 131)])
def test_level_plan_covers_the_chain(size):
    h0, w0 = size
    ss, octaves = _octaves(w0, h0)
    for batch in (128, 1):
        total = 0
        schedules = []
        for oi, specs, h, w in octaves:
            plans = _plan(specs, h, w, oi == 0, batch)
            total += plan_launches(plans, oi + 1 < len(octaves))
            schedules.append({p.schedule for p in plans[1 if oi == 0 else 0 :]})
            for li, (spec, p) in enumerate(zip(specs, plans)):
                first = oi == 0 and li == 0
                assert p.sweeps == (0 if first else len(spec.taus))
                stages = [l.stage for l in p.launches]
                if first:
                    assert stages == ["detect"]
                else:
                    assert stages in (["level"], ["diffuse", "detect"])
                diffusion = [l for l in p.launches if l.stage != "detect"]
                reach = 2 * spec.sigma_size + 1  # Lsmooth rows the detect cascade reads
                for l in p.launches:
                    need = {"diffuse": l.sweeps + 3, "detect": reach, "level": max(l.sweeps + 3, reach + 2)}[l.stage]
                    assert l.halo >= need
                    assert 0 < l.smem <= SMEM_MAX and l.threads in (256, 1024)
                    planes = 4 if l.stage == "level" else 3
                    assert l.smem == 4 * planes * min(h, l.tile[0] + 2 * l.halo) * min(w, l.tile[1] + 2 * l.halo)
                if p.schedule == "plane":
                    assert 12 * h * w <= SMEM_MAX and all(l.tile == (h, w) for l in diffusion)
                elif not first and batch >= 64:
                    assert 12 * h * w > SMEM_MAX
        # No level runs its sweeps one launch at a time any more: at most 40
        # __global__ launches per batch (one launch per stage and sweep made ~250).
        assert total <= 40
        if size == (480, 640):
            assert total == (30 if batch == 128 else 19)
            assert schedules == ([{"tiled"}, {"tiled"}, {"plane"}, {"plane"}] if batch == 128 else
                                 [{"tiled"}] * 4)
        if size == (240, 320) and batch == 128:
            assert schedules[:2] == [{"tiled"}, {"plane"}]


def test_level_plan_long_levels_fit_one_launch():
    """Every level runs all its sweeps in one launch.  Where the halo of a
    long level would not fit around the default tile (octave 4 of a 4K
    frame with num_octaves=5: 34-57 sweeps on 135x240 planes), the tile
    shrinks until it does; the tile follows the card's SM count; a level
    that fits on no tile raises."""
    n_taus, sizes = [34, 40, 48, 57], [2, 3, 3, 4]
    plans = level_plan(135, 240, n_taus, sizes, False, 128, H100_SMS)
    assert [p.schedule for p in plans] == ["tiled"] * 4
    for n, p in zip(n_taus, plans):
        diffuse, detect = p.launches
        assert (diffuse.stage, diffuse.sweeps, diffuse.halo) == ("diffuse", n, n + 3)
        assert diffuse.smem <= SMEM_MAX and detect.stage == "detect"
    assert [p.launches[0].tile for p in plans] == [(64, 64), (32, 32), (32, 32), (16, 16)]
    # 12 frames of 240x320 make 240 64x64 tiles: two per SM need 264 on a
    # 132-SM card, 228 on a 114-SM card.
    assert level_plan(240, 320, [4], [2], False, 3, H100_SMS)[0].launches[0].tile == (16, 32)
    assert level_plan(240, 320, [4], [2], False, 12, 132)[0].launches[0].tile == (16, 32)
    assert level_plan(240, 320, [4], [2], False, 12, 114)[0].launches[0].tile == (64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        level_plan(200, 200, [120], [2], False, 1, H100_SMS)


def _tiles(h, w, tile):
    for oy0 in range(0, h, tile[0]):
        for ox0 in range(0, w, tile[1]):
            yield oy0, ox0, min(h, oy0 + tile[0]), min(w, ox0 + tile[1])


def _per_tile(launch, h, w, fn):
    """fn(extent slices, tile slices within the extent, tile slices within
    the plane) for every output tile of a launch."""
    for oy0, ox0, oy1, ox1 in _tiles(h, w, launch.tile):
        ty0, tx0 = max(0, oy0 - launch.halo), max(0, ox0 - launch.halo)
        ty1, tx1 = min(h, oy1 + launch.halo), min(w, ox1 + launch.halo)
        fn((slice(ty0, ty1), slice(tx0, tx1)),
           (slice(oy0 - ty0, oy1 - ty0), slice(ox0 - tx0, ox1 - tx0)),
           (slice(oy0, oy1), slice(ox0, ox1)))


def _replay_base_stage(imgs, sigma0, tile, halo):
    """Kernel 1 as its blocks run it: base_stage_plain on each tile's extent
    alone (so every stage clamps at the extent's border), the tile kept."""
    seed, modg = torch.empty_like(imgs), torch.empty_like(imgs)

    def run(ext, ctr, dst):
        s, m = base_stage_plain(imgs[(..., *ext)], sigma0)
        seed[(..., *dst)] = s[(..., *ctr)]
        modg[(..., *dst)] = m[(..., *ctr)]

    _per_tile(SimpleNamespace(tile=tile, halo=halo), *imgs.shape[-2:], run)
    return seed, modg


@pytest.mark.parametrize("size", [(480, 640), (97, 131), (5, 7)])
def test_base_stage_tiles_are_exact(size):
    """Kernel 1's tiles and halo give base_stage_plain bit for bit on a VGA
    frame, on ragged tiles and on a frame smaller than one tile; a halo one
    pixel short does not (except where one tile holds the frame)."""
    h, w = size
    frames = video_sequence(2, max(h + 20, 120), max(w + 30, 160), seed=9)
    imgs = torch.from_numpy(frames)[:, 20 : 20 + h, 30 : 30 + w].contiguous()
    assert imgs.shape == (2, h, w)
    # One thread: two calls of base_stage_plain on two VGA frames were seen to
    # differ in modg (1.8e-5) on the rows where torch's CPU kernels split the
    # work between threads, in two of many runs.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = base_stage_plain(imgs, 1.6)
        got = _replay_base_stage(imgs, 1.6, BASE_TILE, BASE_HALO)
        short = _replay_base_stage(imgs, 1.6, BASE_TILE, BASE_HALO - 1)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    whole = h <= BASE_TILE[0] and w <= BASE_TILE[1]
    assert (torch.equal(short[0], want[0]) and torch.equal(short[1], want[1])) == whole


def test_base_stage_taps_drop_zero_ends():
    """Kernel 1 sums the nonzero taps of G_sigma0, as the reference skips
    zero taps; a small sigma0 underflows the end taps to zero."""
    taps = gaussian_kernel(1.6)
    assert len(taps) == 9 and np.array_equal(fed._nonzero_taps(taps, "t"), taps)
    assert fed._nonzero_taps(gaussian_kernel(0.05), "t").tolist() == [1.0]
    with pytest.raises(ValueError, match="zero"):
        fed._nonzero_taps(np.array([0, 1, 0, 1, 0], np.float32), "t")


def _emulate_level(src, k, spec, plan, kind, first, threshold):
    """One level of kernel 2's chain (and kernel 5's Ldet) as its launches
    run it: (Lt, Lx, Ly, Ldet, score, sub)."""
    h, w = src.shape[-2:]
    out = lambda: torch.empty_like(src)
    lx, ly, ldet, score = out(), out(), out(), out()
    sub = torch.empty(src.shape, dtype=torch.int32)

    def detect(ls_t, ctr, dst):
        fields = detector_response_level(ls_t, spec.sigma_size)
        sc, sb = score_fields_plain(fields[2], 0, threshold)
        for plane, f in zip((lx, ly, ldet, score, sub), (*fields, sc, sb)):
            plane[(..., *dst)] = f[(..., *ctr)]

    if first:
        ls = lt = src
    else:
        ls, lt = out(), out()
        launch = plan.launches[0]
        assert launch.sweeps == len(spec.taus)

        def diffuse(ext, ctr, dst):
            l_t = src[(..., *ext)]
            ls_t = gaussian_blur(l_t, 1.0)
            g_t = conductivity(scharr(ls_t, 1, 0, 1), scharr(ls_t, 0, 1, 1), k.reshape(-1, 1, 1), kind)
            ls[(..., *dst)] = ls_t[(..., *ctr)]
            if launch.stage == "level":
                detect(ls_t, ctr, dst)
            lt[(..., *dst)] = fed_cycle(l_t, g_t, spec.taus)[(..., *ctr)]

        _per_tile(launch, h, w, diffuse)
    if plan.launches[-1].stage == "detect":
        _per_tile(plan.launches[-1], h, w, lambda ext, ctr, dst: detect(ls[(..., *ext)], ctr, dst))
    b = spec.border
    ys, xs = torch.arange(h)[:, None], torch.arange(w)[None, :]
    interior = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    return lt, lx, ly, ldet, torch.where(interior, score, torch.full_like(score, NEG)), sub


@pytest.mark.parametrize("plan", ["fused", "apart", "level_plan"])
@pytest.mark.parametrize("diff", list(Diffusivity))
@pytest.mark.parametrize("size", [(97, 131), (60, 80)])
def test_tiled_chain_emulation_is_exact(size, diff, plan):
    """Octaves 0 and 1 equal the plain chain bit for bit on small ragged
    16x24 tiles with the detect cascade in each level's one launch (fused)
    and in a launch of its own (apart), and under level_plan's plan for one
    frame (16x32 tiles, the whole plane at octave 1 of 60x80)."""
    cfg = AkazeConfig(diffusivity=diff)
    _, octaves = _octaves(size[1], size[0], cfg)
    imgs = torch.from_numpy(video_sequence(2, 120, 160, seed=3))[:, : size[0], : size[1]].contiguous()
    seed, modg = base_stage_plain(imgs, cfg.base_scale_offset)
    k = torch.tensor([0.021, 0.043])
    thr = 1e-4
    seen = set()
    for oi, specs, h, w in octaves[:2]:
        if plan == "level_plan":
            plans = _plan(specs, h, w, oi == 0, 1)
        else:
            plans = custom_plan(specs, h, w, oi == 0, (16, 24), plan == "fused")
        seen |= {l.stage for p in plans for l in p.launches}
        x = seed
        for li, (spec, p) in enumerate(zip(specs, plans)):
            first = oi == 0 and li == 0
            got = _emulate_level(x, k, spec, p, diff, first, thr)
            want = fused_level_batched_plain(x, k, spec, diff, first)
            for name, a, b in zip(("Lt", "Lx", "Ly", "Ldet"), got, want):
                assert torch.equal(a, b), (oi, li, name)
            for name, a, b in zip(("score", "sub"), got[4:], score_fields_plain(want[3], spec.border, thr)):
                assert torch.equal(a, b), (oi, li, name)
            x = want[0]
        seed = half_size(x)
    assert ("level" in seen) == (plan != "apart") and ("diffuse" in seen) == (plan == "apart")


def test_plan_argument_leaves_the_cpu_twins_alone():
    """CPU tensors take the plain twins whatever plan is given, and count
    no launch."""
    _, octaves = _octaves(80, 60)
    _, specs, h, w = octaves[0]
    seed = torch.rand(1, h, w)
    k = torch.tensor([0.03])
    plans = custom_plan(specs, h, w, True, (16, 24), False)
    n0 = dict(fed.device_launches)
    got = fused_octave(seed, k, specs, Diffusivity.PM_G2, True, 1e-4, True, plan=plans)
    want = fused_octave_plain(seed, k, specs, Diffusivity.PM_G2, True, 1e-4, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = fused_level_batched(seed, k, specs[1], Diffusivity.PM_G2, False, plan=plans[1:2])
    for a, b in zip(got, fused_level_batched_plain(seed, k, specs[1], Diffusivity.PM_G2, False)):
        assert torch.equal(a, b)
    assert fed.device_launches == n0
