"""The decomposition of kernels 3 and 6 (`csrc/describe.cu`) replayed on the
CPU.

The CUDA kernel cannot run here, so `_replay` does what its blocks do, in
plain PyTorch, from the very table (`kernel_table`) and per-level arguments
(`_level_args`) the wrapper hands the kernel: the persistent grid's strided
walk over the slots (dead slots zeroed, live ones compacted in thread
order), then per live slot, thread task by thread task: one orientation
sample per thread; (range, window) tasks summing WIN_SPLIT sample ranges
in order; warp 0 adding each window's range sums in range order, each lane
keeping the first max of its windows, then the shuffle tree (ties keep the
lower window; a NaN norm counts as the largest, as torch.argmax takes it);
up to four M-LDB samples per thread; (cell, part) tasks of
CELL_PART members; part sums added in part order; bits packed per warp
and round by a ballot.  It must equal the plain twins (`describe_plain`,
`describe_pallas_plain`) bit for bit, and stay within the gates of JAX's
`describe_fused` and `describe_pallas` (interpret mode).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.types import Keypoints as JaxKeypoints
from akaze_tpu.frontend.pipeline import _statics as jax_statics
from akaze_tpu.kernels.describe_fused import describe_fused as jax_describe_fused
from akaze_tpu.kernels.describe_pallas import describe_pallas as jax_describe_pallas
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.detect import detect, detect_dense, find_candidates_oct
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.kernels.describe import (
    CELL_PART, THREADS, TWO_PI, WIN_SPLIT, _cell_means_in_member_order, _level_args, kernel_table,
    _window_sums, atan2_cephes, describe_plain, mod_2pi,
)
from akaze_tpu_torch.kernels.describe_single import describe_pallas_plain
from akaze_tpu_torch.kernels.fed import build_scale_space, build_scale_space_levels
from akaze_tpu_torch.utils.synthetic import video_sequence
from torch_port_helpers import hamming, wrapped_angle_diff

torch.set_num_threads(2)

H, W = 240, 320
CHANNELS = ("Lt", "Lx", "Ly")
RESIDENT = 132 * 8  # the kernel's default grid on an H100: 132 SMs x 8 resident blocks
# Keypoints planted on the deepest octave and at the plane border: (x, y)
# in octave-0 pixels, level (as tests/test_torch_describe_single.py).
PLANTED = [(100.0, 200.0, 11), (300.0, 220.0, 10), (20.0, 20.0, 9), (160.0, 120.0, 8),
           (0.0, 0.0, 0), (319.0, 239.0, 3), (2.0, 237.0, 7)]


def _tables(ds):
    """The kernel's table cut into its named arrays (csrc/describe.cu's
    layout note)."""
    tab, (n_ori, n_win, n_samp, n_cells, n_tasks, n_bits, n_words, _) = kernel_table(ds)
    f = torch.from_numpy(tab.view(np.float32).copy())
    i = torch.from_numpy(tab.astype(np.int64))
    names = [("ori_di", n_ori), ("ori_dj", n_ori), ("ori_w", n_ori), ("win_lo", n_win), ("win_hi", n_win),
             ("win_wrap", n_win), ("offk", n_samp), ("offl", n_samp), ("cell_w", n_cells)]
    t, o = {}, 0
    for name, n in names:
        t[name], o = f[o : o + n], o + n
    for name, n in (("cell_start", n_cells + 1), ("cell_first", n_cells + 1), ("task_cell", n_tasks),
                    ("bits", n_bits)):
        t[name], o = i[o : o + n], o + n
    members = torch.from_numpy(tab[o:].view(np.uint16).astype(np.int64))
    t["members"] = members[: int(t["cell_start"][-1])]
    t.update(n_ori=n_ori, n_win=n_win, n_samp=n_samp, n_cells=n_cells, n_tasks=n_tasks, n_bits=n_bits,
             n_words=n_words)
    return t


def _walk(valid: torch.Tensor, grid: int):
    """The persistent grid's walk: block b owns slots b, b + grid, ...,
    THREADS per round; returns the dead slots and the live ones in the order
    the blocks describe them.  Every slot is owned exactly once."""
    n = valid.numel()
    seen = torch.zeros(n, dtype=torch.long)
    dead, live = [], []
    for b in range(grid):
        owned = (n - 1 - b) // grid + 1 if n > b else 0
        for j0 in range(0, owned, THREADS):
            kp = b + (j0 + torch.arange(min(THREADS, owned - j0))) * grid
            seen[kp] += 1
            v = valid[kp]
            dead.append(kp[~v])
            live.append(kp[v])  # compacted in thread order: warp counts, then lanes below
    assert (seen == 1).all()
    return torch.cat(dead) if dead else torch.zeros(0, dtype=torch.long), torch.cat(live)


def _replay_slots(t, kp, x, y, lvl, groups, B, M, lv_f, lv_i):
    """Describe the live slots kp (n,) as the kernel's block does, vectorised
    over the slots.  groups: per group (Lt, Lx, Ly) of (n_g, B, h, w) or,
    B = 1, (L, H0, W0) planes."""
    lv_f, lv_i = torch.from_numpy(lv_f), torch.from_numpy(lv_i.astype(np.int64))
    xf, yf = x / lv_f[0][lvl], y / lv_f[0][lvl]
    sc, xmax, ymax = lv_f[1][lvl][:, None], lv_f[2][lvl][:, None], lv_f[3][lvl][:, None]
    g, li = lv_i[0][lvl], lv_i[1][lvl]
    frame = kp // M

    def gather(ch, offx, offy):
        """Samples of channel ch at floor(x + off * scale + 0.5) clipped to
        the level, read at iy * w + ix past the slot's plane offset."""
        gx = torch.floor((xf[:, None] + offx * sc) + 0.5)
        gy = torch.floor((yf[:, None] + offy * sc) + 0.5)
        ix = torch.minimum(torch.clamp(gx, min=0.0), xmax).long()
        iy = torch.minimum(torch.clamp(gy, min=0.0), ymax).long()
        out = torch.zeros(ix.shape)
        for gi, planes in enumerate(groups):
            h, w = planes[ch].shape[-2:]
            sel = g == gi
            off = (li[sel] * B + frame[sel]) * h * w
            out[sel] = planes[ch].reshape(-1)[off[:, None] + iy[sel] * w + ix[sel]]
        return out

    n_ori, n_win = t["n_ori"], t["n_win"]
    # Orientation: thread s < n_ori takes sample s.
    vx = t["ori_w"] * gather(1, t["ori_di"], t["ori_dj"])
    vy = t["ori_w"] * gather(2, t["ori_di"], t["ori_dj"])
    ang = mod_2pi(atan2_cephes(vy, vx))
    # Window tasks: task = r * n_win + wi sums samples r * wlen ... in order.
    wlen = -(-n_ori // WIN_SPLIT)
    task = torch.arange(n_win * WIN_SPLIT)
    r, wi = task // n_win, task % n_win
    lo, hi, wrap = t["win_lo"][wi], t["win_hi"][wi], t["win_wrap"][wi] > 0.5
    hw = hi - float(np.float32(2 * np.pi))
    sx = torch.zeros(len(kp), len(task))
    sy = torch.zeros(len(kp), len(task))
    for k in range(wlen):
        s = r * wlen + k
        step = s < torch.clamp((r + 1) * wlen, max=n_ori)
        a = ang[:, torch.clamp(s, max=n_ori - 1)]
        inside = step & torch.where(wrap, (a > lo) | (a < hw), (a > lo) & (a < hi))
        sx = sx + torch.where(inside, vx[:, torch.clamp(s, max=n_ori - 1)], 0.0)
        sy = sy + torch.where(inside, vy[:, torch.clamp(s, max=n_ori - 1)], 0.0)
    part = torch.stack([sx, sy]).reshape(2, len(kp), WIN_SPLIT, n_win)
    # Warp 0: lane l takes windows l, l + 32, ...; then the shuffle tree.
    bn = torch.full((len(kp), 32), -1.0)
    bi = torch.full((len(kp), 32), 1 << 30)
    bx, by = torch.zeros(len(kp), 32), torch.zeros(len(kp), 32)
    for w0 in range(0, n_win, 32):
        lanes = torch.arange(min(32, n_win - w0))
        wsum = part[:, :, 0, w0 + lanes]
        for rr in range(1, WIN_SPLIT):
            wsum = wsum + part[:, :, rr, w0 + lanes]
        nrm = wsum[0] * wsum[0] + wsum[1] * wsum[1]
        take = torch.where(torch.isnan(nrm), ~torch.isnan(bn[:, lanes]), nrm > bn[:, lanes])
        bn[:, lanes] = torch.where(take, nrm, bn[:, lanes])
        bi[:, lanes] = torch.where(take, w0 + lanes, bi[:, lanes])
        bx[:, lanes] = torch.where(take, wsum[0], bx[:, lanes])
        by[:, lanes] = torch.where(take, wsum[1], by[:, lanes])
    for o in (16, 8, 4, 2, 1):
        other = torch.arange(32) ^ o
        on, oi, ox, oy = bn[:, other], bi[:, other], bx[:, other], by[:, other]
        o_nan, b_nan = torch.isnan(on), torch.isnan(bn)
        take = torch.where(o_nan, ~b_nan | (oi < bi), ~b_nan & ((on > bn) | ((on == bn) & (oi < bi))))
        bn, bi = torch.where(take, on, bn), torch.where(take, oi, bi)
        bx, by = torch.where(take, ox, bx), torch.where(take, oy, by)
    angle = mod_2pi(atan2_cephes(by[:, 0], bx[:, 0]))
    co, si = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    # M-LDB: thread j of round q takes sample j + q THREADS.
    u = torch.arange(THREADS)[None, :] + THREADS * torch.arange(-(-t["n_samp"] // THREADS))[:, None]
    u = u.reshape(-1)
    u = u[u < t["n_samp"]]
    assert torch.equal(u.sort().values, torch.arange(t["n_samp"]))
    k, l = t["offk"][u], t["offl"][u]
    syo = l * co + k * si
    sxo = (-l) * si + k * co
    lt, gx, gy = (gather(ch, sxo, syo) for ch in range(3))
    smp = torch.zeros(3, len(kp), t["n_samp"])
    smp[:, :, u] = torch.stack([lt, gx * co + gy * si, (-gx) * si + gy * co])
    # Cell tasks: (cell, part) sums CELL_PART members from 0, three channels.
    tc = t["task_cell"]
    m0 = t["cell_start"][tc] + (torch.arange(t["n_tasks"]) - t["cell_first"][tc]) * CELL_PART
    m1 = torch.minimum(t["cell_start"][tc + 1], m0 + CELL_PART)
    cw = t["cell_w"][tc]
    cpart = torch.zeros(3, len(kp), t["n_tasks"])
    for j in range(CELL_PART):
        m = m0 + j
        idx = t["members"][torch.clamp(m, max=len(t["members"]) - 1)]
        cpart = cpart + torch.where(m < m1, smp[:, :, idx] * cw, 0.0)
    # Means: each (channel, cell)'s part sums added in part order.
    f0, f1 = t["cell_first"][:-1], t["cell_first"][1:]
    mean = cpart[:, :, f0]
    for j in range(1, int((f1 - f0).max())):
        mean = mean + torch.where(f0 + j < f1, cpart[:, :, torch.clamp(f0 + j, max=t["n_tasks"] - 1)], 0.0)
    mean = mean.permute(1, 0, 2).reshape(len(kp), -1)  # index ch * n_cells + cell
    # Bits: round b0, warp w packs word b0 / 32 + w with a ballot of its lanes.
    words = torch.zeros(len(kp), t["n_words"], dtype=torch.long)
    for b0 in range(0, t["n_words"] * 32, THREADS):
        for warp in range(THREADS // 32):
            wd = b0 // 32 + warp
            b = b0 + 32 * warp + torch.arange(32)
            ok = b < t["n_bits"]
            pr = t["bits"][torch.clamp(b, max=t["n_bits"] - 1)]
            bit = ok & (mean[:, pr & 0xFFFF] > mean[:, pr >> 16])
            if wd < t["n_words"]:
                words[:, wd] = (bit.long() << torch.arange(32)).sum(-1)
    inter = {"vx": vx, "vy": vy, "ang": ang, "part": part, "smp": smp, "mean": mean}
    return angle, torch.where(words >= 2**31, words - 2**32, words).to(torch.int32), inter


def _replay(kps, groups, ss, ds, single: bool, grid: int):
    """Angles (N,) and words (N, W) of the N slots of kps through the
    kernel's walk and slot decomposition."""
    B, M = (1, kps.x.shape[0]) if single else kps.x.shape
    t = _tables(ds)
    flat = lambda a: a.reshape(-1)
    dead, live = _walk(flat(kps.valid), grid)
    angle = torch.full((B * M,), float("nan"))
    words = torch.full((B * M, t["n_words"]), -7, dtype=torch.int32)
    angle[dead], words[dead] = 0.0, 0
    inter = {}
    if len(live):
        lv_f, lv_i = _level_args(ss, single)
        a, w, inter = _replay_slots(t, live, flat(kps.x)[live], flat(kps.y)[live],
                                    flat(kps.class_id)[live].long(), groups, B, M, lv_f, lv_i)
        angle[live], words[live] = a, w
    return angle, words, inter


def _check_sums(inter, ds):
    """The replay's window sums and cell means equal the twin's
    `_window_sums` and `_cell_means_in_member_order` on the same samples
    (a changed order moves them by an ULP long before it flips a bit)."""
    lo, hi = torch.from_numpy(ds.win_lo)[:, None], torch.from_numpy(ds.win_hi)[:, None]
    a = inter["ang"][:, None, :]
    inside = torch.where(torch.from_numpy(ds.win_wrap)[:, None], (a > lo) | (a < hi - TWO_PI), (a > lo) & (a < hi))
    part = inter["part"]
    for c, r in enumerate((inter["vx"], inter["vy"])):
        want = part[c, :, 0]
        for j in range(1, WIN_SPLIT):
            want = want + part[c, :, j]
        torch.testing.assert_close(_window_sums(inside, r), want, rtol=0, atol=0, equal_nan=True)
    twin = torch.cat([_cell_means_in_member_order(inter["smp"], g["members"], g["weights"])
                      for g in ds.on("cpu").grids], dim=2)
    torch.testing.assert_close(twin.permute(1, 0, 2).reshape(twin.shape[1], -1), inter["mean"], rtol=0, atol=0,
                               equal_nan=True)


@pytest.fixture(scope="module")
def batch_scene():
    """Two 240x320 frames through the port's plain batched build (kernel
    3's inputs), with holes in the valid prefix."""
    ss, ds = _statics(W, H, AkazeConfig())
    st = build_scale_space(torch.from_numpy(video_sequence(2, H, W, seed=3)), ss, plain=True)
    kps = detect(find_candidates_oct(st["oct"], ss), st["oct"], ss)
    kps.valid[0, [3, 5, 8, 9, 10, 40]] = False
    kps.valid[1, 17:30] = False
    return ss, ds, kps, st["lvl_oct"]


@pytest.fixture(scope="module")
def single_scene():
    """One 240x320 frame through the port's plain per-level build (kernel
    6's padded stacks), 64 slots, keypoints planted on the deepest octave
    and at the plane border."""
    cfg = AkazeConfig(max_keypoints=64)
    ss, ds = _statics(W, H, cfg)
    st = build_scale_space_levels(torch.from_numpy(video_sequence(1, H, W, seed=3)), ss, plain=True)
    kp = detect_dense(st["Ldet"], ss).index(0)
    at = slice(20, 20 + len(PLANTED))
    x, y, lvl = zip(*PLANTED)
    kp.x[at], kp.y[at] = torch.tensor(x), torch.tensor(y)
    kp.class_id[at], kp.valid[at] = torch.tensor(lvl, dtype=torch.int32), True
    kp.valid[[2, 9]] = False
    return ss, ds, kp, {k: st[k][0].contiguous() for k in CHANNELS}


def _groups(lvl_oct):
    return [tuple(o[k] for k in CHANNELS) for o in lvl_oct]


def _crowded(lvl_oct):
    """The scene's planes with constant gradients (Lx = 1, Ly = 0.5): every
    orientation sample has one angle, so all 109 fall in the same windows."""
    return tuple({"Lt": o["Lt"], "Lx": torch.ones_like(o["Lx"]), "Ly": torch.full_like(o["Ly"], 0.5)}
                 for o in lvl_oct)


def _nan_band(lvl_oct):
    """The scene's planes with a NaN band two columns wide down the middle
    of every Lx plane: the orientation windows of the keypoints near it
    sum NaN, and NaN samples enter their cell means."""
    out = []
    for o in lvl_oct:
        lx = o["Lx"].clone()
        c = lx.shape[-1] // 2
        lx[..., c : c + 2] = float("nan")
        out.append({"Lt": o["Lt"], "Lx": lx, "Ly": o["Ly"]})
    return tuple(out)


BATCH_CASES = ["holes", "all dead", "ragged grid", "crowded", "nan band"]


@pytest.mark.parametrize("case", BATCH_CASES)
def test_batch_replay_equals_twin(batch_scene, case):
    """Kernel 3's decomposition on the batched layout equals describe_plain
    bit for bit: holes in the valid prefix (default H100 grid), every slot
    dead, 2,000 slots on 7 blocks (three rounds, the last ragged), a
    scene whose orientation samples crowd one window, and NaN samples (the
    first NaN window wins the orientation)."""
    ss, ds, kps, lvl_oct = batch_scene
    grid = RESIDENT
    if case == "all dead":
        kps = dataclasses.replace(kps, valid=torch.zeros_like(kps.valid))
    elif case == "ragged grid":
        kps = dataclasses.replace(kps, **{f.name: getattr(kps, f.name)[:, :1000].contiguous()
                                          for f in dataclasses.fields(kps)})
        grid = 7
    elif case == "crowded":
        lvl_oct = _crowded(lvl_oct)
    elif case == "nan band":
        lvl_oct = _nan_band(lvl_oct)
    ang, words, inter = _replay(kps, _groups(lvl_oct), ss, ds, single=False, grid=grid)
    ang_p, words_p = describe_plain(kps, lvl_oct, ss, ds)
    assert torch.equal(ang, ang_p.reshape(-1)) and torch.equal(words, words_p.reshape(words.shape))
    if inter:
        _check_sums(inter, ds)
    v = kps.valid.reshape(-1)
    assert (words[~v] == 0).all() and (ang[~v] == 0).all()
    if case == "crowded":
        assert (ang[v] == ang[v][0]).all()  # one angle: every window saw the same samples
    elif case == "nan band":  # some slots take a NaN window: atan2(NaN, NaN) is pi / 2 in the Cephes form
        nan_ang = mod_2pi(atan2_cephes(torch.tensor([float("nan")]), torch.tensor([float("nan")])))
        assert torch.isfinite(ang[v]).all() and int((ang[v] == nan_ang).sum()) >= 5
    elif case != "all dead":
        assert int(v.sum()) > 200 and len(torch.unique(ang[v])) > 100


def test_single_replay_equals_twin(single_scene):
    """Kernel 6's layout (one frame's padded stacks, one group of L planes):
    samples clipped at the plane border and at the deepest level."""
    ss, ds, kp, stacks = single_scene
    ang, words, inter = _replay(kp, [tuple(stacks[k] for k in CHANNELS)], ss, ds, single=True, grid=64)
    ang_p, words_p = describe_pallas_plain(kp, stacks, ss, ds)
    assert torch.equal(ang, ang_p) and torch.equal(words, words_p)
    _check_sums(inter, ds)
    assert (words[kp.valid] != 0).any(dim=-1).all() and (words[~kp.valid] == 0).all()


def _check_gates(ang_ref, desc_ref, ang, desc, valid):
    assert wrapped_angle_diff(ang_ref[valid], ang[valid]).max() < 1e-5
    ham = hamming(desc_ref[valid], desc[valid])
    assert ham.mean() <= 3 and ham.max() <= 12


def _jax_kps(kps):
    return JaxKeypoints(**{f.name: np.asarray(getattr(kps, f.name)) for f in dataclasses.fields(kps)})


def test_batch_replay_within_jax_gates(batch_scene):
    ss, ds, kps, lvl_oct = batch_scene
    ang, words, _ = _replay(kps, _groups(lvl_oct), ss, ds, single=False, grid=RESIDENT)
    jss, jds = jax_statics(W, H, JaxAkazeConfig())
    stacks = {"lvl_oct": tuple({k: o[k].numpy() for k in CHANNELS} for o in lvl_oct)}
    fa, fd = jax_describe_fused(_jax_kps(kps), stacks, jss, jds, interpret=True)
    v = kps.valid.reshape(-1).numpy()
    _check_gates(np.asarray(fa).reshape(-1), np.asarray(fd).reshape(len(v), -1), ang.numpy(), words.numpy(), v)


def test_single_replay_within_jax_gates(single_scene):
    ss, ds, kp, stacks = single_scene
    ang, words, _ = _replay(kp, [tuple(stacks[k] for k in CHANNELS)], ss, ds, single=True, grid=64)
    jss, jds = jax_statics(W, H, JaxAkazeConfig(max_keypoints=64))
    ja, jd = jax_describe_pallas(_jax_kps(kp), {k: stacks[k].numpy() for k in CHANNELS}, jss, jds,
                                 interpret=True)
    _check_gates(np.asarray(ja), np.asarray(jd).view(np.int32), ang.numpy(), words.numpy(), kp.valid.numpy())


def test_decomposition_follows_the_kernel_source():
    """The replay's split constants are the kernel's."""
    src = (Path(__file__).resolve().parents[1] / "akaze_tpu_torch" / "csrc" / "describe.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\d+)$", src, flags=re.M))
    assert (int(defines["THREADS"]), int(defines["WIN_SPLIT"]), int(defines["CELL_PART"])) == (
        THREADS, WIN_SPLIT, CELL_PART)
