"""Kernel 7's plain twin (`gather_patches_plain`) against the JAX package's
`gather_patches` in interpret mode, bit for bit, in the four cases of
tests/test_patch_gather.py (aligned planes, odd 51x200 planes, level-major
stacks, one frame's stacks), plus what the port adds: any slot count, the
padded restack of the per-octave planes, and windows that reach into a
level's zero padding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.kernels.patch_pallas import gather_patches as jax_gather_patches
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.describe import restack_levels
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.patch import gather_patches

CASES = {
    "aligned": dict(seed=0, F=3, L=4, H=96, W=256, N=64, ph=40, pw=64),
    "odd": dict(seed=1, F=2, L=3, H=51, W=200, N=32, ph=24, pw=48),
    "level_major": dict(seed=3, F=3, L=4, H=96, W=256, N=64, ph=40, pw=64),
    "single_frame": dict(seed=2, F=1, L=4, H=64, W=256, N=32, ph=32, pw=64),
}


def _case(seed, F, L, H, W, N, ph, pw):
    """The inputs of tests/test_patch_gather.py::_random_case."""
    rng = np.random.default_rng(seed)
    stk = {k: rng.standard_normal((F, L, H, W)).astype(np.float32) for k in ("Lt", "Lx", "Ly")}
    frame = rng.integers(0, F, N)
    lvl = rng.integers(0, L, N)
    y0 = rng.integers(0, max(H - ph, 0) + 1, N)
    x0 = rng.integers(0, max(W - pw, 0) + 1, N)
    valid = rng.random(N) < 0.8
    y0[:4] = [0, max(H - ph, 0), 1, max(H - ph - 1, 0)]
    x0[:4] = [0, max(W - pw, 0), 1, max(W - pw - 1, 0)]
    valid[:4] = True
    return stk, frame, lvl, y0, x0, valid


@pytest.mark.parametrize("name", list(CASES))
def test_gather_matches_jax_interpret(name):
    c = CASES[name]
    stk, frame, lvl, y0, x0, valid = _case(**c)
    if name == "level_major":
        stk = {k: np.ascontiguousarray(np.moveaxis(v, 0, 1)) for k, v in stk.items()}
    elif name == "single_frame":
        stk = {k: v[0] for k, v in stk.items()}
        frame = np.zeros_like(frame)
    jstk = {k: jnp.asarray(v) for k, v in stk.items()}
    tstk = {k: torch.from_numpy(v) for k, v in stk.items()}
    if name == "level_major":
        jstk["level_major"] = tstk["level_major"] = True
    idx = (frame, lvl, y0, x0)
    want = jax_gather_patches(jstk, *(jnp.asarray(a, jnp.int32) for a in idx), jnp.asarray(valid),
                              ph=c["ph"], pw=c["pw"], interpret=True)
    n0 = _build.launches["gather_patches"]
    got = gather_patches(tstk, *(torch.from_numpy(a) for a in idx), torch.from_numpy(valid),
                         c["ph"], c["pw"])
    assert _build.launches["gather_patches"] == n0  # CPU tensors take the twin
    assert got.shape == (c["N"], 3, c["ph"], c["pw"]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~valid] == 0).all()


def test_gather_any_slot_count_and_clamped_origins():
    """13 slots (not a multiple of 8); origins past the plane clamp as
    lax.dynamic_slice clamps them."""
    stk, frame, lvl, y0, x0, valid = _case(seed=5, F=2, L=3, H=40, W=72, N=13, ph=16, pw=24)
    y0[5], x0[6], y0[7] = 1000, 1000, -7
    valid[5:8] = True
    got = gather_patches({k: torch.from_numpy(v) for k, v in stk.items()},
                         *(torch.from_numpy(a) for a in (frame, lvl, y0, x0, valid)), 16, 24).numpy()
    for n in range(13):
        if not valid[n]:
            assert (got[n] == 0).all()
            continue
        y, x = min(max(y0[n], 0), 40 - 16), min(max(x0[n], 0), 72 - 24)
        for c, k in enumerate(("Lt", "Lx", "Ly")):
            np.testing.assert_array_equal(got[n, c], stk[k][frame[n], lvl[n], y : y + 16, x : x + 24])
    with pytest.raises(ValueError):
        gather_patches({k: torch.from_numpy(v) for k, v in stk.items()},
                       *(torch.from_numpy(a) for a in (frame, lvl, y0, x0, valid)), 41, 24)


def test_restack_pads_and_deep_windows_read_the_padding():
    """At 320x240 the deepest octave is 80x60 and the patch 64x64: its
    windows run into the restacked stack's zero rows."""
    ss, ds = _statics(320, 240, AkazeConfig())
    rng = np.random.default_rng(7)
    B = 2
    lvl_oct = tuple(
        {k: torch.from_numpy(rng.standard_normal((n, B, h, w)).astype(np.float32) + 5.0)
         for k in ("Lt", "Lx", "Ly")}
        for _, n, h, w in ss.groups)
    st = restack_levels(lvl_oct, ss)
    assert st["level_major"] and st["Lt"].shape == (ss.num_levels, B, 240, 320)
    for (l0, n, h, w), o in zip(ss.groups, lvl_oct):
        for k in ("Lt", "Lx", "Ly"):
            assert torch.equal(st[k][l0 : l0 + n, :, :h, :w], o[k])
            assert (st[k][l0 : l0 + n, :, h:] == 0).all() and (st[k][l0 : l0 + n, :, :, w:] == 0).all()
    deepest = ss.num_levels - 1
    assert (ss.heights[deepest], ds.ph) == (60, 64)
    one = torch.ones(1, dtype=torch.int64)
    p = gather_patches(st, one, one * deepest, one * 0, one * 10, one, ds.ph, ds.pw)[0]
    assert (p[:, :60] != 0).all() and (p[:, 60:] == 0).all()
