"""The port's two-view geometry (`akaze_tpu_torch/geometry/twoview.py`)
against the JAX package's on the CPU: each function on seeded inputs, the
whole RANSAC with JAX's own random draws passed in as `sample_scores`, the
tie rules, and the contracts (TF32 off at import, copied configs and
synthetic pairs equal to JAX's, configs converting field for field).

Tolerances: `_det8` and `_nullspace_9` within 1e-4 of the norm; the other
functions within 1e-5; whole poses R within 0.05 deg, t-direction within
0.2 deg and inlier counts within max(1, 1 %)."""

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

from akaze_tpu.core import config as jax_config
from akaze_tpu.geometry import twoview as J
from akaze_tpu.utils import synthetic as jax_synthetic
from akaze_tpu_torch import interop
from akaze_tpu_torch.core import config
from akaze_tpu_torch.kernels.topk import topk_stable
from akaze_tpu_torch.frontend.pipeline import extract_batch
from akaze_tpu_torch.geometry import twoview as T
from akaze_tpu_torch.matching.hamming import match_features
from akaze_tpu_torch.utils import synthetic
from test_geometry import _synthetic_pair
from torch_port_helpers import ROT_BOUND_DEG, TDIR_BOUND_DEG, assert_same_pose, rot_deg, tdir_err_deg

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _host(res):
    return T.TwoViewResult(**{f.name: getattr(res, f.name).cpu().numpy() for f in dataclasses.fields(res)})


# ---------------------------------------------------------------- functions


def test_det8_matches_jax():
    rng = np.random.default_rng(0)
    m = (rng.normal(size=(64, 8, 8)) + 3 * np.eye(8)).astype(np.float32)  # well conditioned
    want = np.asarray(J._det8(jnp.asarray(m)))
    got = T._det8(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got, np.linalg.det(m.astype(np.float64)), rtol=1e-4)


def test_nullspace_9_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 64, 8, 9)).astype(np.float32)
    want = np.asarray(J._nullspace_9(jnp.asarray(a)))
    got = T._nullspace_9(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert np.abs(np.einsum("...ij,...j->...i", a, got)).max() < 1e-4  # a null vector


def test_argmax_takes_the_first_maximum():
    """_det8's pivot, _recover_pose's candidate and the beam winner rest on
    torch.argmax taking the first maximum, as jnp.argmax does."""
    for dtype in (torch.float32, torch.int32):
        x = torch.tensor([[1, 3, 3, 2], [5, 5, 5, 5], [0, 1, 0, 1]], dtype=dtype)
        assert torch.argmax(x, dim=-1).tolist() == [1, 0, 1]
        assert torch.argmax(x, dim=-1).tolist() == np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=-1)).tolist()
    # Tied pivots: rows with equal |entries| in every column the elimination meets.
    m = np.eye(8, dtype=np.float32)
    m[1, 0], m[2, 0], m[0, 0] = -1.0, 1.0, 1.0
    m[5] = -m[4]
    m[5, 5] += 2.0
    np.testing.assert_array_equal(T._det8(torch.from_numpy(m)).numpy(), np.asarray(J._det8(jnp.asarray(m))))


def test_enforce_essential_matches_jax():
    rng = np.random.default_rng(2)
    e = rng.normal(size=(128, 3, 3)).astype(np.float32)
    e[0] = np.diag([1.0, 1.0, 0.5])  # tau == 0 with apq == 0
    e[1] = [[1, 1, 0], [1, 1, 0], [0, 0, 1]]  # app == aqq, apq != 0: the 45-degree rule
    e[2] = np.diag([2.0, 2.0, 2.0])  # tied singular values: index tie-break of the rank
    want = np.asarray(J._enforce_essential(jnp.asarray(e)))
    got = T._enforce_essential(torch.from_numpy(e)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    s = np.linalg.svd(got[3:].astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, np.broadcast_to([1.0, 1.0, 0.0], s.shape), atol=1e-4)


def test_sampson_and_triangulate_match_jax():
    rng = np.random.default_rng(3)
    E = rng.normal(size=(16, 3, 3)).astype(np.float32)
    x1, x2, *_ = _synthetic_pair(n=100, n_outliers=20, seed=4)
    want = np.asarray(J._sampson_sq(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2)))
    got = T._sampson_sq(*(torch.from_numpy(v) for v in (E, x1, x2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(4)]).astype(np.float32)
    t = rng.normal(size=(4, 3)).astype(np.float32)
    want = np.asarray(J.triangulate(*(jnp.asarray(v) for v in (R, t, x1, x2))))
    got = T.triangulate(*(torch.from_numpy(v) for v in (R, t, x1, x2))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_recover_pose_matches_jax():
    x1, x2, mask, R_gt, t_gt, _ = _synthetic_pair(n=150, n_outliers=0, seed=5)
    tx = np.array([[0, -t_gt[2], t_gt[1]], [t_gt[2], 0, -t_gt[0]], [-t_gt[1], t_gt[0], 0]])
    E = (tx @ R_gt).astype(np.float32)
    inl = np.ones(150, bool)
    inl[::7] = False
    Rj, tj, cj = (np.asarray(v) for v in J._recover_pose(*(jnp.asarray(v) for v in (E, x1, x2, inl))))
    Rt, tt, ct = T._recover_pose(*(torch.from_numpy(v) for v in (E, x1, x2, inl)))
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), tj, atol=1e-5)
    assert int(ct) == int(cj) == inl.sum()
    assert rot_deg(Rt.numpy().astype(np.float64), R_gt) < 0.01 and tt.numpy() @ t_gt > 0.9999


# ------------------------------------------------------------- whole RANSAC


def _jax_draws(seed, cfg, n):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.uniform(key, (cfg.num_iterations, n)))


def _both(x1, x2, mask, seed, **cfg):
    """The JAX result and the port's CPU result on JAX's draws."""
    jcfg, tcfg = jax_config.RansacConfig(**cfg), config.RansacConfig(**cfg)
    key, g = _jax_draws(seed, jcfg, len(mask))
    ref = J.estimate_relative_pose(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jcfg, key)
    got = T.estimate_relative_pose(x1, x2, mask, tcfg, device="cpu", sample_scores=g)
    return ref, _host(got)


# tests/test_geometry.py's three cases: outliers; noise with a loose
# threshold; a mask that keeps the first 100 slots.
GEOMETRY_CASES = {
    "outliers": (dict(seed=0), dict(num_iterations=256)),
    "noise": (dict(noise=1e-3, seed=2), dict(num_iterations=512, inlier_threshold=5e-3)),
    "mask": (dict(n_outliers=0, seed=3), {}),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_ransac_matches_jax_on_synthetic_pairs(case):
    pair_kw, cfg = GEOMETRY_CASES[case]
    x1, x2, mask, R_gt, t_gt, n_in = _synthetic_pair(**pair_kw)
    if case == "mask":
        mask[100:] = False
    ref, got = _both(x1, x2, mask, pair_kw["seed"], **cfg)
    assert_same_pose(ref, got)
    assert not got.inliers[~mask].any()
    assert rot_deg(got.R.astype(np.float64), R_gt) < 2.0


@pytest.fixture(scope="module")
def plane_matches():
    """The port's CPU correspondences of multi_plane_pair(seed=6)."""
    img_a, img_b, R_gt, t_gt, intr = synthetic.multi_plane_pair(seed=6)
    feats = extract_batch(np.stack([img_a, img_b]), device="cpu")
    m = match_features(feats.index(0), feats.index(1), device="cpu")
    kp = feats.keypoints
    x1 = T.normalize_points(kp.x[0], kp.y[0], intr)
    x2 = T.normalize_points(kp.x[1][m.idx_b.long()], kp.y[1][m.idx_b.long()], intr)
    return x1.numpy(), x2.numpy(), m.accepted.numpy(), R_gt, t_gt


def test_ransac_matches_jax_on_multi_plane_matches(plane_matches):
    x1, x2, mask, R_gt, t_gt = plane_matches
    assert mask.sum() >= 100
    ref, got = _both(x1, x2, mask, 0, num_iterations=512, inlier_threshold=2e-3)
    assert_same_pose(ref, got)
    assert rot_deg(got.R.astype(np.float64), R_gt) <= ROT_BOUND_DEG
    assert tdir_err_deg(got.t.astype(np.float64), t_gt) <= TDIR_BOUND_DEG


def test_many_equal_beam_counts_match_jax():
    """Noise-free matches at a loose threshold: most hypotheses count every
    match, so the beam is decided by the lower-index rule alone."""
    x1, x2, mask, *_ = _synthetic_pair(n_outliers=0, seed=6)
    cfg = dict(num_iterations=512, inlier_threshold=5e-3)
    tcfg = config.RansacConfig(**cfg)
    _, g = _jax_draws(7, tcfg, len(mask))
    _, _, scores = T._hypotheses(*(torch.from_numpy(np.array(v))[None] for v in (x1, x2, mask, g)), tcfg)
    assert int((scores == scores.max()).sum()) >= 4 * tcfg.refit_beam
    _, top = topk_stable(scores.to(torch.float32), tcfg.refit_beam)
    np.testing.assert_array_equal(top[0].numpy(), np.asarray(jax.lax.top_k(jnp.asarray(scores[0].numpy()),
                                                                            tcfg.refit_beam)[1]))
    ref, got = _both(x1, x2, mask, 7, **cfg)
    assert_same_pose(ref, got)
    assert int(got.num_inliers) == len(mask)


def test_fewer_than_eight_valid_slots():
    """Six valid slots: every 8-subset takes the two lowest invalid slots
    (score -1 ties), as lax.top_k does; the refit's nullspace is not
    unique there, so only the guard and the essential form are checked."""
    x1, x2, mask, *_ = _synthetic_pair(n=40, n_outliers=0, seed=8)
    mask[:] = False
    mask[[3, 9, 17, 20, 31, 38]] = True
    tcfg = config.RansacConfig()
    _, g = _jax_draws(9, tcfg, len(mask))
    gm = np.where(mask[None], g, -1.0).astype(np.float32)
    _, idx = topk_stable(torch.from_numpy(gm), tcfg.sample_size)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(gm), tcfg.sample_size)[1]))
    assert set(idx[:, 6:].reshape(-1).tolist()) == {0, 1}

    t = [torch.from_numpy(np.array(v))[None] for v in (x1, x2, mask, g)]
    E_h, inl_h, cnt_h = T._hypotheses(*t, tcfg)
    _, top = topk_stable(cnt_h.to(torch.float32), tcfg.refit_beam)
    E0, inl0, cnt0 = (T._take(v, top) for v in (E_h, inl_h, cnt_h))
    E, inl, cnt = T._refit(E0, inl0, cnt0, t[0], t[1], t[2], tcfg)
    assert (cnt >= cnt0).all()  # the guard: no round loses inliers
    assert torch.equal(cnt, inl.sum(-1, dtype=torch.int32)) and not inl[..., ~t[2][0]].any()
    s = torch.linalg.svd(E.double()).S
    assert torch.allclose(s / s[..., :1], torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64), atol=1e-4)
    ref, got = _both(x1, x2, mask, 9)
    for r in (ref, got):
        inl = np.asarray(r.inliers)
        assert int(r.num_inliers) <= 6 and not inl[~mask].any()
        s = np.linalg.svd(np.asarray(r.E, np.float64), compute_uv=False)
        np.testing.assert_allclose(s / s[0], [1.0, 1.0, 0.0], atol=1e-4)


def test_own_generator_is_seeded_from_the_config():
    x1, x2, mask, R_gt, *_ = _synthetic_pair(seed=0)
    cfg = config.RansacConfig(num_iterations=256)
    a = _host(T.estimate_relative_pose(x1, x2, mask, cfg, device="cpu"))
    b = _host(T.estimate_relative_pose(x1, x2, mask, cfg, device="cpu"))
    gen = torch.Generator().manual_seed(cfg.seed)
    c = _host(T.estimate_relative_pose(x1, x2, mask, cfg, generator=gen, device="cpu"))
    draws = torch.rand((cfg.num_iterations, len(mask)), generator=torch.Generator().manual_seed(cfg.seed))
    d = _host(T.estimate_relative_pose(x1, x2, mask, cfg, device="cpu", sample_scores=draws))
    for r in (b, c, d):
        np.testing.assert_array_equal(r.R, a.R)
        np.testing.assert_array_equal(r.inliers, a.inliers)
    assert rot_deg(a.R.astype(np.float64), R_gt) < 0.5


def test_cuda_is_the_default_device():
    x1, x2, mask, *_ = _synthetic_pair(n=20, n_outliers=0, seed=1)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.estimate_relative_pose(x1, x2, mask)
    with pytest.raises(RuntimeError, match="CUDA"):  # CPU tensors do not choose the device either
        T.estimate_relative_pose(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask))


def test_batched_pairs_equal_single_pairs():
    """The leading pair axis: P pairs in one call equal P single calls."""
    cases = [_synthetic_pair(seed=s) for s in (0, 1, 2)]
    cfg = config.RansacConfig(num_iterations=128, refit_beam=8)
    g = torch.rand((3, cfg.num_iterations, 200), generator=torch.Generator().manual_seed(5))
    x1, x2, mask = (torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(3))
    batch = T.estimate_relative_pose_fn(x1, x2, mask, cfg, sample_scores=g)
    for p in range(3):
        one = T.estimate_relative_pose_fn(x1[p], x2[p], mask[p], cfg, sample_scores=g[p])
        assert torch.allclose(batch.R[p], one.R, atol=1e-6) and torch.allclose(batch.t[p], one.t, atol=1e-6)
        assert torch.equal(batch.inliers[p], one.inliers) and int(batch.num_inliers[p]) == int(one.num_inliers)


@pytest.mark.parametrize("seed", [5, 7, 8])
def test_port_two_view_within_reference_bound_on_cpu(seed):
    """tests/test_two_view_bound.py's gate on the port's CPU path, on that
    test's random scores (PRNGKey(0)); seed 6 is checked against JAX above.
    The bound holds for those draws: with other draws the reference misses
    it on some scenes too (tools/twoview_draw_sweep.py)."""
    img_a, img_b, R_gt, t_gt, intr = synthetic.multi_plane_pair(seed=seed)
    feats = extract_batch(np.stack([img_a, img_b]), device="cpu")
    m = match_features(feats.index(0), feats.index(1), device="cpu")
    kp = feats.keypoints
    x1 = T.normalize_points(kp.x[0], kp.y[0], intr)
    x2 = T.normalize_points(kp.x[1][m.idx_b.long()], kp.y[1][m.idx_b.long()], intr)
    cfg = config.RansacConfig(num_iterations=512, inlier_threshold=2e-3)
    _, g = _jax_draws(cfg.seed, cfg, x1.shape[0])
    res = T.estimate_relative_pose(x1, x2, m.accepted, cfg, device="cpu", sample_scores=g)
    assert rot_deg(res.R.numpy().astype(np.float64), R_gt) <= ROT_BOUND_DEG
    assert tdir_err_deg(res.t.numpy().astype(np.float64), t_gt) <= TDIR_BOUND_DEG
    assert int(res.num_inliers) >= 30


@pytest.mark.parametrize("seed, shape", [(0, (512, 1024)), (7, (3, 5, 11)), (2**32 - 1, (40,)), (99, ())])
def test_jax_uniform_equals_jax_random(seed, shape):
    np.testing.assert_array_equal(interop.jax_uniform(seed, shape),
                                  np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape)))


# ---------------------------------------------------------------- contracts


_TF32_SCRIPT = textwrap.dedent("""
    import sys
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    import akaze_tpu_torch.geometry.twoview  # noqa: F401
    assert "akaze_tpu_torch.frontend.pipeline" not in sys.modules
    assert torch.backends.cuda.matmul.allow_tf32 is False, "TF32 still on"
    assert torch.get_float32_matmul_precision() == "highest"
""")


def test_twoview_turns_tf32_off_at_its_own_import():
    out = subprocess.run([sys.executable, "-c", _TF32_SCRIPT], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr


def test_copied_configs_and_synthetic_pairs_equal_jax():
    for cls, jcls in ((config.RansacConfig, jax_config.RansacConfig), (config.SfmConfig, jax_config.SfmConfig),
                      (config.MeshConfig, jax_config.MeshConfig)):
        assert dataclasses.asdict(cls()) == dataclasses.asdict(jcls())
        assert [f.name for f in dataclasses.fields(cls)] == [f.name for f in dataclasses.fields(jcls)]
        assert cls.__dataclass_params__.frozen
    mesh = jax_config.MeshConfig(data=3, spatial=2)
    assert interop.config_from_fields(dataclasses.asdict(mesh)) == config.MeshConfig(data=3, spatial=2)
    assert config.MeshConfig(data=3, spatial=2).num_devices == mesh.num_devices == 6
    for seed in (5, 11):
        for got, want in zip(synthetic.multi_plane_pair(seed=seed), jax_synthetic.multi_plane_pair(seed=seed)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        img = synthetic.textured_scene(60, 80, seed=seed)
        H = np.array([[1.0, 0.02, 3.0 + seed], [-0.01, 1.0, -2.0], [1e-5, 0, 1.0]])
        np.testing.assert_array_equal(synthetic.warp_homography(img, H), jax_synthetic.warp_homography(img, H))


def test_config_from_fields_round_trips_all_four_configs():
    jaxes = [
        jax_config.AkazeConfig(diffusivity=jax_config.Diffusivity.PM_G1, num_octaves=3),
        jax_config.MatchConfig(ratio=0.7, max_distance=120),
        jax_config.RansacConfig(num_iterations=256, refit_beam=8),
        jax_config.SfmConfig(keyframe_min_tracked=0.7, ba_iterations=4),
    ]
    ports = [
        config.AkazeConfig(diffusivity=config.Diffusivity.PM_G1, num_octaves=3),
        config.MatchConfig(ratio=0.7, max_distance=120),
        config.RansacConfig(num_iterations=256, refit_beam=8),
        config.SfmConfig(keyframe_min_tracked=0.7, ba_iterations=4),
    ]
    for jcfg, want in zip(jaxes, ports):
        assert interop.config_from_fields(dataclasses.asdict(jcfg)) == want
        assert interop.config_from_fields(dataclasses.asdict(want)) == want
    assert interop.config_from_fields({"seed": 3}) == config.RansacConfig(seed=3)
    assert interop.config_from_fields({"huber_delta": 2.0}) == config.SfmConfig(huber_delta=2.0)
