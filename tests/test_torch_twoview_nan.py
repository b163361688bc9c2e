"""Two-view RANSAC on correspondences that hold NaN: the port on the CPU
against the JAX package on JAX's own random draws.

The reference's refit weighs the design matrix by the inlier mask, so a
NaN row stays NaN (NaN x 0) even where the mask is false: its refit scores
no inliers and every refit round of that problem is rejected.  The pose is
the unrefined beam winner.  An 8-point sample that holds a NaN row gives a
NaN essential matrix, which counts no inliers and no points in front of
the cameras.  Tolerances: tests/test_torch_twoview.py's (R within 0.05 deg,
t-direction within 0.2 deg), inlier counts equal."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core import config as jax_config
from akaze_tpu.geometry import twoview as J
from akaze_tpu_torch import interop
from akaze_tpu_torch.core import config
from akaze_tpu_torch.kernels.topk import topk_stable
from akaze_tpu_torch.geometry import twoview as T
from torch_port_helpers import assert_same_pose

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(2)
ITERS = 64


def translated_scene(seed: int = 0):
    """64 points of a random scene before and after a 0.3 x-translation
    (R = I, t = (-1, 0, 0)): chip_smoke.py phase 10b's input."""
    return chip_smoke.nan_pair_inputs(np, seed=seed)


def _jax_pose(x1, x2, mask):
    key = jax.random.PRNGKey(0)
    res = J.estimate_relative_pose(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                                   jax_config.RansacConfig(num_iterations=ITERS), key)
    return T.TwoViewResult(**{f.name: np.asarray(getattr(res, f.name)) for f in dataclasses.fields(res)})


def _port_pose(x1, x2, mask):
    draws = interop.jax_uniform(0, (ITERS, x1.shape[-2]))
    if x1.ndim == 3:
        draws = np.broadcast_to(draws, (x1.shape[0], *draws.shape))
    return T.estimate_relative_pose(x1, x2, mask, config.RansacConfig(num_iterations=ITERS), device="cpu",
                                    sample_scores=draws)


# (rows of x1 set to NaN, whether the mask keeps them)
CASES = {
    "clean": (slice(0, 0), True),
    "one_row": (slice(5, 6), True),
    "one_row_masked_out": (slice(5, 6), False),
    "every_eighth_row": (slice(None, None, 8), True),
    "every_third_row": (slice(None, None, 3), True),
    "every_second_row": (slice(None, None, 2), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nan_rows_give_the_reference_pose(case):
    rows, keep = CASES[case]
    x1, x2, mask = translated_scene()
    x1[rows] = np.nan
    mask[rows] = keep
    ref = _jax_pose(x1, x2, mask)
    got = _port_pose(x1, x2, mask)  # torch's CPU SVD raises on NaN: the port must keep NaN out of it
    n = int(ref.num_inliers)
    assert int(got.num_inliers) == n
    assert not got.inliers[torch.from_numpy(~np.isfinite(x1).all(-1))].any()
    if n == 0:  # every hypothesis held a NaN row: a NaN pose in both packages
        assert np.isnan(ref.t).all() and torch.isnan(got.t).all() and torch.isnan(got.R).all()
        return
    assert_same_pose(ref, got)
    assert abs(float(got.t[0]) + 1.0) < 1e-4
    expect = {"clean": 64, "one_row": 63, "one_row_masked_out": 63}
    if case in expect:
        assert n == expect[case]


def test_chip_check_holds_the_reference_counts():
    """chip_smoke.py phase 10b's cases and the inlier counts it holds the
    card to are the JAX package's."""
    for name, (rows, keep, want) in chip_smoke.NAN_PAIR_CASES.items():
        assert CASES[name] == (rows, keep)
        x1, x2, mask = translated_scene()
        x1[rows] = np.nan
        mask[rows] = keep
        assert int(_jax_pose(x1, x2, mask).num_inliers) == want, name


def test_one_poisoned_problem_leaves_the_others_bit_equal():
    """P = 3 problems in one call, the middle one with a NaN row: the other
    two equal, bit for bit, their results in a batch without the NaN."""
    scenes = [translated_scene(seed) for seed in (1, 2, 3)]
    x1, x2, mask = (np.stack([s[i] for s in scenes]) for i in range(3))
    clean = _port_pose(x1, x2, mask)
    x1[1, 7] = np.nan
    mixed = _port_pose(x1, x2, mask)
    for p in (0, 2):
        for f in dataclasses.fields(clean):
            assert torch.equal(getattr(mixed, f.name)[p], getattr(clean, f.name)[p]), (p, f.name)
    one = _port_pose(x1[1], x2[1], mask[1])
    assert int(mixed.num_inliers[1]) == int(one.num_inliers) == int(_jax_pose(x1[1], x2[1], mask[1]).num_inliers)


@pytest.mark.parametrize("keep", [True, False])
def test_refit_keeps_the_beam_of_a_poisoned_problem(keep):
    """No refit round of a problem with a NaN row is accepted, masked or
    not: the beam leaves `_refit` as it came in, while a clean problem of
    the same batch is refit."""
    cfg = config.RansacConfig(num_iterations=ITERS)
    scenes = [translated_scene(seed) for seed in (0, 4)]
    x1, x2, mask = (torch.from_numpy(np.stack([s[i] for s in scenes])) for i in range(3))
    x1[0, 5] = float("nan")
    mask[0, 5] = keep
    g = torch.from_numpy(np.broadcast_to(interop.jax_uniform(0, (ITERS, x1.shape[1])), (2, ITERS, x1.shape[1])).copy())
    E_h, inl_h, cnt_h = T._hypotheses(x1, x2, mask, g, cfg)
    _, top = topk_stable(cnt_h.to(torch.float32), cfg.refit_beam)
    E0, inl0, cnt0 = (T._take(v, top) for v in (E_h, inl_h, cnt_h))
    E, inl, cnt = T._refit(E0, inl0, cnt0, x1, x2, mask, cfg)
    assert torch.equal(E[0], E0[0]) and torch.equal(inl[0], inl0[0]) and torch.equal(cnt[0], cnt0[0])
    assert not torch.equal(E[1], E0[1]) and torch.equal(cnt[1], inl[1].sum(-1, dtype=torch.int32))
