"""The port's incremental SfM (`akaze_tpu_torch/sfm/{incremental,
pose_graph,metrics,checkpoint}.py`) against the JAX package's on the CPU,
on the scenes of tests/test_sfm.py and tests/test_elastic.py.

Tolerances: build_tracks exactly equal; refine_pose_pnp and its Jacobian
within 1e-5; one window super-step: validity exactly equal, poses within
1e-4, triangulated points within 1e-3 of their distance (the float32
midpoint solve at small parallax); the pose graph (and its Jacobian, relative to its
largest entry) within 1e-4; run_incremental on tests/test_sfm.py's K = 10
scene with JAX's random draws: the same valid points, camera centers within
1e-3, ATE < 0.05; checkpoint resume: tests/test_elastic.py's gates; the
own copies (sfm_scene, metrics, checkpoint files) equal to the originals."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import RansacConfig as JaxRansacConfig
from akaze_tpu.core.config import SfmConfig as JaxSfmConfig
from akaze_tpu.sfm import checkpoint as JC
from akaze_tpu.sfm import incremental as JI
from akaze_tpu.sfm import metrics as JM
from akaze_tpu.sfm import pose_graph as JP
from akaze_tpu.sfm.rotations import rotvec_to_matrix as jax_rotvec_to_matrix
from akaze_tpu.utils import synthetic as jax_synthetic
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
from akaze_tpu_torch.sfm import checkpoint as TC
from akaze_tpu_torch.sfm import incremental as TI
from akaze_tpu_torch.sfm import metrics as TM
from akaze_tpu_torch.sfm import pose_graph as TP
from akaze_tpu_torch.utils import synthetic
from akaze_tpu_torch.utils.profiling import check_no_nan, debug_checks_enabled, enable_debug_checks

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
_RANSAC = dict(num_iterations=256, inlier_threshold=5e-3)


def _synthetic_sequence(K=12, n_pts=300, noise=0.0, seed=0):
    """tests/test_sfm.py's `_synthetic_sequence` (a camera arc around a
    cloud; per-track normalized observations) with the same draws, its
    rotations computed once per camera by the reference's rotvec_to_matrix
    instead of once per observation."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-3, -2, 8], [3, 2, 16], (n_pts, 3))
    poses = np.zeros((K, 6), np.float32)
    for k in range(K):
        poses[k, :3] = [0.0, 0.04 * k, 0.005 * k]
        poses[k, 3:] = [-0.35 * k, 0.01 * k, 0.05 * k]
    rots = np.asarray(jax_rotvec_to_matrix(jnp.asarray(poses[:, :3])))
    observations = []
    for p in range(n_pts):
        tr = {}
        for k in range(K):
            xc = rots[k] @ pts[p] + poses[k, 3:]
            if xc[2] <= 0.1:
                continue
            uv = xc[:2] / xc[2] + rng.normal(0, noise, 2)
            if np.abs(uv).max() < 0.6:  # field of view
                tr[k] = uv.astype(np.float32)
        if len(tr) >= 2:
            observations.append(tr)
    return observations, poses, pts


@pytest.fixture(scope="module")
def scene():
    """tests/test_sfm.py's K = 10, noise 5e-4, seed 2 scene."""
    return _synthetic_sequence(K=10, noise=5e-4, seed=2)


def test_build_tracks_equal_jax():
    rng = np.random.default_rng(3)
    matches = []
    for _ in range(6):
        a = rng.choice(40, 25, replace=False)
        b = rng.choice(40, 25, replace=False)
        matches.append(np.stack([a, b], axis=1))
    assert TI.build_tracks(matches, 7) == JI.build_tracks(matches, 7)
    simple = [np.array([[0, 1], [2, 3]]), np.array([[1, 5], [7, 8]])]
    assert TI.build_tracks(simple, 3) == JI.build_tracks(simple, 3) == [{0: 0, 1: 1, 2: 5}, {0: 2, 1: 3}, {1: 7, 2: 8}]


# ---------------------------------------------------------------- PnP


def _pnp_case(seed=1, n=50, noise=1e-3, outliers=5, masked=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 5], [2, 2, 10], (n, 3)).astype(np.float32)
    gt = np.array([0.1, -0.05, 0.02, 0.3, -0.1, 0.2], np.float32)
    r = synthetic._rotvec_to_matrix_np(gt[:3].astype(np.float64))
    xc = pts @ r.T + gt[3:]
    uv = (xc[:, :2] / xc[:, 2:3] + rng.normal(0, noise, (n, 2))).astype(np.float32)
    uv[:outliers] += 0.2  # gross outliers the Huber weights cut down
    valid = np.ones(n, np.float32)
    valid[n - masked :] = 0.0
    return pts, uv, valid, gt


def _jax_pnp_residuals(points, uv, valid):
    """The residual of the reference's refine_pose_pnp (its closure)."""
    def residuals(p):
        r = jax_rotvec_to_matrix(p[:3])
        xc = points @ r.T + p[3:]
        z = jnp.where(jnp.abs(xc[:, 2]) < 1e-9, 1e-9, xc[:, 2])
        res = jnp.stack([xc[:, 0] / z - uv[:, 0], xc[:, 1] / z - uv[:, 1]], -1)
        return (res * valid[:, None]).reshape(-1)
    return residuals


@pytest.mark.parametrize("case", ["exact", "noise and outliers"])
def test_refine_pose_pnp_matches_jax(case):
    """tests/test_sfm.py's exact case (recovers the pose within 1e-4), and
    one with noise, gross outliers and masked correspondences."""
    pts, uv, valid, gt = _pnp_case(noise=0.0, outliers=0, masked=0) if case == "exact" else _pnp_case()
    start = np.zeros(6, np.float32)
    want = np.asarray(JI.refine_pose_pnp(jnp.asarray(start), jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid)))
    got = TI.refine_pose_pnp(*(torch.from_numpy(x) for x in (start, pts, uv, valid))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if case == "exact":
        np.testing.assert_allclose(got, gt, atol=1e-4)
    # Its residuals and closed-form Jacobian against jax.jacfwd.
    p0 = np.array([0.05, -0.02, 0.01, 0.2, 0.0, 0.1], np.float32)
    j_want = np.asarray(jax.jacfwd(_jax_pnp_residuals(*(jnp.asarray(x) for x in (pts, uv, valid))))(jnp.asarray(p0)))
    r_got, j_got = TI._pnp_linearize(torch.from_numpy(p0), *(torch.from_numpy(x) for x in (pts, uv, valid)))
    r_want = np.asarray(_jax_pnp_residuals(*(jnp.asarray(x) for x in (pts, uv, valid)))(jnp.asarray(p0)))
    np.testing.assert_allclose(r_got.numpy(), r_want, atol=1e-6, rtol=0)
    assert np.abs(j_got.numpy() - j_want).max() < 1e-5 * np.abs(j_want).max()


# ---------------------------------------------------------------- window


def _window_inputs(scene, point_noise, cap=256):
    """A window over keyframes 1-4 of the scene: 60 % of the points of
    tracks seen at keyframe 0 valid (true positions plus point_noise), the
    others to triangulate from their first keyframe; schedules padded with
    the sentinel row cap (repeated in every step)."""
    observations, gt_poses, gt_pts = scene
    rng = np.random.default_rng(0)
    K = len(gt_poses)
    poses = (gt_poses + rng.normal(0, 2e-3, gt_poses.shape)).astype(np.float32)
    poses[0] = gt_poses[0]
    tracks = [ti for ti, tr in enumerate(observations) if len(tr) >= 2][: cap - 8]
    points = np.zeros((cap + 1, 3), np.float32)
    valid = np.zeros(cap + 1, bool)
    rows = {}
    for row, ti in enumerate(tracks):
        rows[ti] = row
        if 0 in observations[ti] and rng.uniform() < 0.6:
            points[row] = gt_pts[ti] + rng.normal(0, point_noise, 3)
            valid[row] = True
    window = [1, 2, 3, 4]
    n = 128
    sched = {k: np.zeros((len(window), n) + s, t) for k, s, t in (
        ("pnp_rows", (), np.int32), ("pnp_uv", (2,), np.float32), ("pnp_w", (), np.float32),
        ("tri_rows", (), np.int32), ("tri_anc", (), np.int32), ("tri_uva", (2,), np.float32),
        ("tri_uvb", (2,), np.float32), ("tri_w", (), np.float32))}
    sched["pnp_rows"][:] = cap
    sched["tri_rows"][:] = cap
    for wi, k in enumerate(window):
        seen = [ti for ti in tracks if k in observations[ti]]
        for s, ti in enumerate(seen[:n]):
            sched["pnp_rows"][wi, s] = rows[ti]
            sched["pnp_uv"][wi, s] = observations[ti][k]
            sched["pnp_w"][wi, s] = 1.0
        tri = [ti for ti in seen if min(observations[ti]) < k and not valid[rows[ti]]]
        for s, ti in enumerate(tri[:n]):
            a = min(observations[ti])
            sched["tri_rows"][wi, s] = rows[ti]
            sched["tri_anc"][wi, s] = a
            sched["tri_uva"][wi, s] = observations[ti][a]
            sched["tri_uvb"][wi, s] = observations[ti][k]
            sched["tri_w"][wi, s] = 1.0
    return poses, points, valid, window, sched


@pytest.mark.parametrize("case", ["exact", "noisy"])
def test_window_superstep_matches_jax(scene, case):
    """Validity exactly equal and poses within 1e-4, without noise and with
    the scene's 5e-4 observation noise and points 1e-2 off.  A new point
    comes from the float32 midpoint solve, whose 2x2 determinant is
    ~sin^2 of the parallax (the gate lets 0.57 deg through): a rounding
    difference between the packages moves it by up to ~5e-4 of its
    distance in either case, so its tolerance is 1e-3 of its distance."""
    if case == "exact":
        scene = _synthetic_sequence(K=10, noise=0.0, seed=2)
    poses, points, valid, window, sched = _window_inputs(scene, 0.0 if case == "exact" else 1e-2)
    order = ("pnp_rows", "pnp_uv", "pnp_w", "tri_rows", "tri_anc", "tri_uva", "tri_uvb", "tri_w")
    assert (sched["tri_rows"] == len(points) - 1).sum(axis=1).min() > 1  # the sentinel repeats in every step
    assert (sched["tri_w"] > 0).sum() > 20 and (sched["pnp_w"] > 0).sum(axis=1).min() >= 6
    want = JI._window_superstep(jnp.asarray(poses), jnp.asarray(points), jnp.asarray(valid),
                                jnp.asarray(np.asarray(window, np.int32)), *(jnp.asarray(sched[k]) for k in order))
    got = TI._window_superstep(torch.from_numpy(poses), torch.from_numpy(points), torch.from_numpy(valid), window,
                               *(torch.from_numpy(sched[k]).long() if sched[k].dtype == np.int32
                                 else torch.from_numpy(sched[k]) for k in order))
    w_poses, w_points, w_valid = (np.asarray(x) for x in want)
    g_poses, g_points, g_valid = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_valid, w_valid)
    assert w_valid.sum() > valid.sum() + 20  # rows were triangulated
    assert not g_valid[-1] and not g_points[-1].any()  # the sentinel row stays as it was
    np.testing.assert_allclose(g_poses, w_poses, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(g_points[valid], w_points[valid])  # valid rows are left alone
    err = np.abs(g_points[g_valid] - w_points[w_valid]).max(axis=1)
    assert (err / np.linalg.norm(w_points[w_valid], axis=1)).max() < 1e-3


# ---------------------------------------------------------------- pose graph


def _drift_graph(weighted: bool):
    """tests/test_sfm.py's drift case: odometry + one closure, exact
    measurements, drifted initial poses."""
    K = 8
    gt = np.zeros((K, 6), np.float32)
    gt[:, 1] = 0.1 * np.arange(K)
    gt[:, 3] = -0.5 * np.arange(K)
    gt[:, 5] = 0.05 * np.arange(K)
    gt_j = jnp.asarray(gt)
    ei = list(range(1, K)) + [K - 1]
    ej = list(range(0, K - 1)) + [0]
    rels = np.stack([np.asarray(JP.relative(gt_j[i], gt_j[j])) for i, j in zip(ei, ej)]).astype(np.float32)
    rng = np.random.default_rng(4)
    init = gt + rng.normal(0, 0.03, gt.shape).astype(np.float32)
    init[0] = gt[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    weight = rng.uniform(1, 100, len(ei)).astype(np.float32) if weighted else None
    fields = dict(poses=init, edge_i=np.asarray(ei, np.int32), edge_j=np.asarray(ej, np.int32), rel=rels,
                  valid=np.ones(len(ei), bool), fixed=fixed, weight=weight)
    jax_graph = JP.PoseGraph(**{k: None if v is None else jnp.asarray(v) for k, v in fields.items()})
    port_graph = TP.PoseGraph(**{k: None if v is None else torch.from_numpy(v) for k, v in fields.items()})
    return jax_graph, port_graph, gt


@pytest.mark.parametrize("weighted", [False, True])
def test_pose_graph_matches_jax(weighted):
    jax_graph, port_graph, gt = _drift_graph(weighted)
    want = np.asarray(JP.optimize_pose_graph(jax_graph, iterations=15).poses)
    got = TP.optimize_pose_graph(port_graph, iterations=15).poses.numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert np.abs(got - gt).max() < 1e-3
    K = gt.shape[0]
    p0 = np.asarray(jax_graph.poses).reshape(-1)
    j_want = np.asarray(jax.jit(jax.jacfwd(lambda p: JP._residuals(p.reshape(K, 6), jax_graph).reshape(-1)))(
        jnp.asarray(p0)))
    graph64 = dataclasses.replace(port_graph, edge_i=port_graph.edge_i.long(), edge_j=port_graph.edge_j.long())
    j_got = torch.func.jacfwd(lambda p: TP._residuals(p.reshape(K, 6), graph64).reshape(-1))(torch.from_numpy(p0))
    assert np.abs(j_got.numpy() - j_want).max() < 1e-4 * np.abs(j_want).max()


def test_compose_invert_relative_match_jax():
    rng = np.random.default_rng(5)
    a = rng.normal(0, 0.7, (16, 6)).astype(np.float32)
    b = rng.normal(0, 0.7, (16, 6)).astype(np.float32)
    for name in ("compose", "relative"):
        want = np.asarray(getattr(JP, name)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(TP, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(TP.invert(torch.from_numpy(a)).numpy(), np.asarray(JP.invert(jnp.asarray(a))),
                               atol=1e-5, rtol=0)


def test_apply_pose_graph_matches_jax():
    """The closure step of run_incremental: odometry edges from the current
    poses, a closure rescaled to the current baseline, the weighted graph."""
    gt, _, closures = synthetic.sfm_scene(24, 50, seed=1, loop=True, num_closures=2)
    rng = np.random.default_rng(2)
    drifted = (gt + np.cumsum(rng.normal(0, 2e-3, gt.shape), axis=0)).astype(np.float32)
    drifted[0] = gt[0]
    want, applied = JI._apply_pose_graph(drifted, 24, closures, 12, JaxSfmConfig())
    got, applied_t = TI._apply_pose_graph(torch.from_numpy(drifted), 24, closures, 12, SfmConfig())
    assert applied and applied_t
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert TI._apply_pose_graph(torch.from_numpy(drifted), 20, closures)[1] is False  # no closure reached


# ---------------------------------------------------------------- run_incremental


def test_run_incremental_matches_jax(scene):
    observations, gt_poses, _ = scene
    want = JI.run_incremental(observations, 10, JaxSfmConfig(ba_iterations=8), JaxRansacConfig(**_RANSAC))
    got = TI.run_incremental(observations, 10, SfmConfig(ba_iterations=8), RansacConfig(**_RANSAC), device="cpu",
                             draws=interop.jax_uniform)
    assert sorted(got.track_point) == sorted(want.track_point) and len(got.points) == len(want.points) > 100
    c_want, c_got = JM.camera_centers(want.poses), TM.camera_centers(got.poses)
    assert np.abs(c_got - c_want).max() < 1e-3
    assert TM.ate_rmse(c_got, TM.camera_centers(gt_poses)) < 0.05


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """tests/test_elastic.py on the port: a run stopped after 9 keyframes
    resumes from its checkpoint and lands on the uninterrupted run."""
    observations, gt_poses, _ = _synthetic_sequence(K=10, noise=5e-4, seed=7)
    scfg, rcfg = SfmConfig(ba_iterations=8), RansacConfig(**_RANSAC)
    full = TI.run_incremental(observations, 10, scfg, rcfg, ba_every=4, device="cpu")
    path = tmp_path / "map.npz"
    TI.run_incremental(observations, 9, scfg, rcfg, ba_every=4, checkpoint_path=str(path), device="cpu")
    ckpt = TC.load_checkpoint(path)
    assert ckpt.next_keyframe == 9
    resumed = TI.run_incremental(observations, 10, scfg, rcfg, ba_every=4, resume=ckpt, device="cpu")
    assert len(resumed.points) == len(full.points)
    np.testing.assert_allclose(resumed.poses, full.poses, atol=5e-2)
    gt_c = TM.camera_centers(gt_poses)
    assert TM.ate_rmse(TM.camera_centers(resumed.poses), gt_c) < TM.ate_rmse(TM.camera_centers(full.poses), gt_c) + 0.02
    # The port's checkpoint loads in the JAX package, and a JAX run resumes from it.
    back = JC.load_checkpoint(path)
    np.testing.assert_array_equal(back.poses, ckpt.poses)
    assert back.track_point == ckpt.track_point and back.next_keyframe == 9


def test_checkpoints_cross_load(tmp_path):
    rng = np.random.default_rng(0)
    fields = dict(poses=rng.normal(size=(4, 6)).astype(np.float32), points=rng.normal(size=(7, 3)).astype(np.float32),
                  track_point={3: 0, 9: 6, 11: 2}, keyframe_frames=[0, 2, 5, 7], next_keyframe=8)
    TC.save_checkpoint(tmp_path / "port.npz", TC.SfmCheckpoint(**fields))
    JC.save_checkpoint(tmp_path / "jax.npz", JC.SfmCheckpoint(**fields))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    for load in (TC.load_checkpoint, JC.load_checkpoint):
        for name in ("port.npz", "jax.npz"):
            got = dataclasses.asdict(load(tmp_path / name))
            for k, v in fields.items():
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))
    jax_ckpt = JC.load_checkpoint(tmp_path / "jax.npz")
    port_ckpt = interop.checkpoint_from_fields(dataclasses.asdict(jax_ckpt))
    assert isinstance(port_ckpt, TC.SfmCheckpoint)
    again = JC.SfmCheckpoint(**dataclasses.asdict(port_ckpt))
    for k in fields:
        np.testing.assert_array_equal(np.asarray(getattr(again, k)), np.asarray(getattr(jax_ckpt, k)))
    assert TC.CHECKPOINT_SCHEMA_VERSION == JC.CHECKPOINT_SCHEMA_VERSION


# ---------------------------------------------------------------- own copies


@pytest.mark.parametrize("args", [(12, 80, 0, False, 5e-4), (30, 120, 3, True, 2e-3)])
def test_sfm_scene_and_metrics_equal_jax(args):
    k, n, seed, loop, noise = args
    got = synthetic.sfm_scene(k, n, seed=seed, loop=loop, obs_noise=noise)
    want = jax_synthetic.sfm_scene(k, n, seed=seed, loop=loop, obs_noise=noise)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) and len(got[2]) == len(want[2])
    for a, b in zip(got[1], want[1]):
        assert sorted(a) == sorted(b)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f])
    for (i, j, r), (i2, j2, r2) in zip(got[2], want[2]):
        assert (i, j) == (i2, j2)
        np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(synthetic._rotvec_to_matrix_np(got[0][-1, :3]),
                                  jax_synthetic._rotvec_to_matrix_np(got[0][-1, :3]))
    rng = np.random.default_rng(seed)
    est = (got[0] + rng.normal(0, 0.01, got[0].shape)).astype(np.float32)
    c_got, c_want = TM.camera_centers(est), JM.camera_centers(est)
    np.testing.assert_allclose(c_got, c_want, atol=1e-6, rtol=0)
    gt_c = JM.camera_centers(got[0])
    assert TM.ate_rmse(c_want, gt_c) == JM.ate_rmse(c_want, gt_c)
    for a, b in zip(TM.umeyama_align(c_want, gt_c, False), JM.umeyama_align(c_want, gt_c, False)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- contracts


_TF32_SCRIPT = textwrap.dedent("""
    import sys
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    import akaze_tpu_torch.sfm.{module}  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 still on"
    assert torch.get_float32_matmul_precision() == "highest"
""")


@pytest.mark.parametrize("module", ["ba", "pose_graph", "incremental"])
def test_sfm_modules_turn_tf32_off_at_their_own_import(module):
    out = subprocess.run([sys.executable, "-c", _TF32_SCRIPT.replace("{module}", module)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr


def test_debug_checks_raise_on_nan_only_while_on(scene):
    """A map resumed with a NaN point carries it to the output: with the
    checks on, run_incremental raises; off, the NaN comes out."""
    observations, gt_poses, gt_pts = scene
    points = gt_pts.astype(np.float32).copy()
    points[0] = np.nan
    ckpt = TC.SfmCheckpoint(poses=gt_poses[:6], points=points, track_point={ti: ti for ti in range(len(points))},
                            keyframe_frames=list(range(6)), next_keyframe=6)
    args = (observations, 7, SfmConfig(ba_iterations=2), RansacConfig(**_RANSAC))
    assert not debug_checks_enabled()
    enable_debug_checks()
    try:
        with pytest.raises(FloatingPointError, match="run_incremental|bundle_adjust"):
            TI.run_incremental(*args, resume=ckpt, device="cpu")
        check_no_nan("finite", torch.ones(3))
    finally:
        enable_debug_checks(False)
    res = TI.run_incremental(*args, resume=ckpt, device="cpu")
    assert np.isnan(res.points[0]).all() and np.isfinite(res.points[1:]).all()
    check_no_nan("off", torch.tensor([np.nan]))  # off: returns without a look


def test_run_incremental_entry_point_contracts(scene):
    observations = scene[0]
    with pytest.raises(TypeError, match="Mesh"):
        TI.run_incremental(observations, 10, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TI.run_incremental(observations, 10)


def test_run_incremental_marks_its_spans(scene):
    """Each window super-step, BA, pose graph and torch.linalg call runs in
    a `utils.profiling.span`: a recorder sees them in order, and a
    torch.profiler trace names them (record_function)."""
    from akaze_tpu_torch.sfm.pose_graph import relative
    from akaze_tpu_torch.utils.profiling import SpanRecorder, record_spans

    observations, gt_poses, _ = scene
    gt = torch.from_numpy(gt_poses)
    closure = (0, 9, relative(gt[9], gt[0]).numpy())
    names = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_spans(SpanRecorder(on_enter=names.append)) as rec:
            TI.run_incremental(observations, 10, SfmConfig(ba_iterations=2), RansacConfig(**_RANSAC), ba_every=4,
                               closures=[closure], device="cpu")
    assert rec.count("sfm.window") == 0  # CUDA events only on the card
    outer = [n for n in names if n.startswith("sfm.")]
    assert outer == ["sfm.window", "sfm.ba"] * 2 + ["sfm.window", "sfm.ba", "sfm.pose_graph", "sfm.ba"]
    assert names.index("geometry.twoview") < names.index("sfm.window")  # the two-view start
    assert names.count("linalg") > 10 * 9  # each keyframe's 10 PnP solves, then the BA and the pose graph
    traced = {e.key for e in prof.key_averages()}
    assert {"sfm.window", "sfm.ba", "sfm.pose_graph", "linalg"} <= traced
