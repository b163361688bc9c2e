"""The port's rotations and bundle adjustment (`akaze_tpu_torch/sfm/
{rotations,ba}.py`) against the JAX package's on the CPU, on the problems
of tests/test_ba.py and tests/test_rotations.py.

Tolerances: rotations within 1e-6 abs (|theta| from 0 to pi), the
closed-form d(R x)/dr within 1e-5 of JAX's jacfwd relative to its largest
entry; residuals and Jacobians within 1e-5 relative to their largest entry; S and rhs within
1e-4 relative; bundle_adjust on noiseless problems, dense (K = 6, P = 64,
Q = 4) and CG (K = 72, P = 320, Q = 4, tests/test_ba.py's long-trajectory
layout): poses within 1e-4 abs, points
within 1e-4 abs (dense) and 1e-4 per unit of distance from the origin
(CG: its points lie 6-25 units out, weakly triangulated from four
consecutive cameras 0.15 apart, and float32 rounding moves them ~2e-4 in
either package), and the rmse gates of tests/test_ba.py on both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akaze_tpu.core.config import SfmConfig as JaxSfmConfig
from akaze_tpu.sfm import ba as J
from akaze_tpu.sfm import rotations as JR
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import SfmConfig
from akaze_tpu_torch.sfm import ba as T
from akaze_tpu_torch.sfm import rotations as TR
from test_ba import _synthetic_problem
from torch_port_helpers import trajectory_problem

torch.set_num_threads(2)

# JAX's pieces jitted once (their eager vmap/jacfwd dispatch takes seconds).
_j_linearize = jax.jit(J._linearize, static_argnums=1)
_j_cost = jax.jit(J._cost, static_argnums=1)
_j_schur = jax.jit(J._schur_system, static_argnums=2)
_j_rotate_jacobian = jax.jit(jax.vmap(jax.jacfwd(JR.rotate)))


def _trajectory_problem():
    fields, poses = trajectory_problem()
    return J.BAProblem(**{k: jnp.asarray(v) for k, v in fields.items()}), poses


def _port(problem) -> T.BAProblem:
    return interop.ba_problem_from_numpy({f: np.asarray(getattr(problem, f)) for f in interop.BA_FIELDS},
                                         device="cpu")


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


# ---------------------------------------------------------------- rotations


@pytest.mark.parametrize(
    "theta", [0.0, 1e-6, 1e-3, 0.5, 1.5, 3.0, np.pi - 0.02, np.pi - 1e-3, np.pi - 1e-5, np.pi])
def test_rotations_match_jax_at_all_angles(theta):
    rng = np.random.default_rng(int(theta * 1e6) % 2**31)
    ax = rng.normal(size=(8, 3))
    rv = (ax / np.linalg.norm(ax, axis=1, keepdims=True) * theta).astype(np.float32)
    m_j = np.asarray(JR.rotvec_to_matrix(jnp.asarray(rv)))
    m_t = TR.rotvec_to_matrix(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(m_t, m_j, atol=1e-6, rtol=0)
    back_j = np.asarray(JR.matrix_to_rotvec(jnp.asarray(m_j)))
    back_t = TR.matrix_to_rotvec(torch.from_numpy(m_j)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-6, rtol=0)
    pts = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(TR.rotate(torch.from_numpy(rv), torch.from_numpy(pts)).numpy(),
                               np.asarray(JR.rotate(jnp.asarray(rv), jnp.asarray(pts))), atol=1e-6, rtol=0)
    # The closed-form d(R x)/dr against JAX's forward-mode derivative.
    pts = 5.0 * pts
    want = np.asarray(_j_rotate_jacobian(jnp.asarray(rv), jnp.asarray(pts)))
    got = TR.rotate_jacobian(torch.from_numpy(rv), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_rotations_batched_and_pi_axis():
    rng = np.random.default_rng(7)
    rv = rng.normal(0, 1.2, (4, 8, 3)).astype(np.float32)
    n = np.linalg.norm(rv, axis=-1, keepdims=True)
    rv = np.where(n > np.pi, rv * (1.0 - 2.0 * np.pi / n), rv).astype(np.float32)
    back = TR.matrix_to_rotvec(TR.rotvec_to_matrix(torch.from_numpy(rv))).numpy()
    np.testing.assert_allclose(back, rv, atol=1e-4)
    for ax in np.eye(3, dtype=np.float32):  # exactly pi: magnitude pi, axis parallel
        back = TR.matrix_to_rotvec(TR.rotvec_to_matrix(torch.from_numpy(ax * np.float32(np.pi)))).numpy()
        assert abs(np.linalg.norm(back) - np.pi) < 1e-4
        assert abs(np.dot(back / np.linalg.norm(back), ax)) > 0.9999


# ---------------------------------------------------------------- BA pieces


@pytest.fixture(scope="module")
def noisy_problem():
    problem, _, _ = _synthetic_problem(noise=1e-3, seed=1)
    valid = np.asarray(problem.obs_valid).copy()
    valid[::7, 0] = False  # tests/test_ba.py's killed observations
    return J.BAProblem(poses=problem.poses, points=problem.points, obs_cam=problem.obs_cam,
                       obs_uv=problem.obs_uv, obs_valid=jnp.asarray(valid), fixed=problem.fixed)


def test_linearize_and_cost_match_jax(noisy_problem):
    want = _j_linearize(noisy_problem, 3.0)
    got = T._linearize(_port(noisy_problem), 3.0)
    for name, g, w in zip(("r", "jc", "jp"), got, want):
        assert _rel(g.numpy(), w) < 1e-5, name
    assert _rel(T._cost(_port(noisy_problem), 3.0).numpy(), _j_cost(noisy_problem, 3.0)) < 1e-5


def test_schur_system_matches_jax(noisy_problem):
    s_j, rhs_j, vinv_j, w_j, gp_j = _j_schur(noisy_problem, jnp.float32(1e-3), JaxSfmConfig())
    s_t, rhs_t, vinv_t, w_t, gp_t = T._schur_system(_port(noisy_problem), torch.tensor(1e-3), SfmConfig())
    assert _rel(s_t.numpy(), s_j) < 1e-4 and _rel(rhs_t.numpy(), rhs_j) < 1e-4
    for g, w in ((vinv_t, vinv_j), (w_t, w_j), (gp_t, gp_j)):
        assert _rel(g.numpy(), w) < 1e-4
    # The CG solve on the same system agrees with JAX's and with a float64 solve.
    K = s_t.shape[0]
    x_j = np.asarray(J._solve_pose_system(s_j, rhs_j))
    x_t = T._solve_pose_system(s_t, rhs_t).numpy()
    exact = np.linalg.solve(s_t.double().permute(0, 2, 1, 3).reshape(6 * K, 6 * K).numpy(),
                            rhs_t.double().reshape(-1).numpy()).reshape(K, 6)
    assert np.abs(x_t - x_j).max() < 1e-4 * np.abs(exact).max() + 1e-7
    assert np.abs(x_t - exact).max() < 1e-3 * np.abs(exact).max()


# ---------------------------------------------------------------- bundle_adjust


def _both(problem, iterations):
    out_j = J.bundle_adjust(problem, JaxSfmConfig(ba_iterations=iterations))
    out_t = T.bundle_adjust(_port(problem), SfmConfig(ba_iterations=iterations))
    return out_j, out_t


def test_bundle_adjust_dense_matches_jax():
    problem, gt_poses, _ = _synthetic_problem()
    assert problem.poses.shape[0] <= T.DENSE_MAX_POSES
    out_j, out_t = _both(problem, 15)
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_t.points.numpy(), np.asarray(out_j.points), atol=1e-4, rtol=0)
    assert float(T.reprojection_rmse(out_t)) < 1e-4 and float(J.reprojection_rmse(out_j)) < 1e-4
    assert np.abs(out_t.poses.numpy() - gt_poses).max() < 1e-2
    # Gauge-fixed poses do not move.
    np.testing.assert_array_equal(out_t.poses.numpy()[:2], np.asarray(problem.poses)[:2])


def test_bundle_adjust_noisy_with_invalid_observations(noisy_problem):
    out_j, out_t = _both(noisy_problem, 15)
    rmse_t, rmse_j = float(T.reprojection_rmse(out_t)), float(J.reprojection_rmse(out_j))
    assert rmse_t < 5e-3 and rmse_j < 5e-3
    assert abs(rmse_t - rmse_j) < 1e-6


def test_bundle_adjust_cg_matches_jax():
    problem, gt_poses = _trajectory_problem()
    assert problem.poses.shape[0] > T.DENSE_MAX_POSES
    out_j, out_t = _both(problem, 8)
    np.testing.assert_allclose(out_t.poses.numpy(), np.asarray(out_j.poses), atol=1e-4, rtol=0)
    pts_j = np.asarray(out_j.points)
    scale = np.maximum(np.linalg.norm(pts_j, axis=1, keepdims=True), 1.0)
    assert (np.abs(out_t.points.numpy() - pts_j) / scale).max() < 1e-4
    assert float(T.reprojection_rmse(out_t)) < 2e-3 and float(J.reprojection_rmse(out_j)) < 2e-3
    assert np.abs(out_t.poses.numpy() - gt_poses).max() < 0.1


def test_ba_problem_round_trips_through_numpy(noisy_problem):
    arrays = {f: np.asarray(getattr(noisy_problem, f)) for f in interop.BA_FIELDS}
    back = interop.ba_problem_to_numpy(_port(noisy_problem))
    assert sorted(back) == sorted(arrays)
    for f in interop.BA_FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f])
        assert back[f].dtype == arrays[f].dtype, f
    J.BAProblem(**{f: jnp.asarray(v) for f, v in back.items()})  # JAX takes it back
