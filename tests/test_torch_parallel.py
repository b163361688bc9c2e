"""The port's parallel paths (`akaze_tpu_torch/parallel/`,
`sfm/ba.py::bundle_adjust_sharded`, `run_incremental(mesh=)`) on real
processes against the JAX package's on its 8 virtual CPU devices.

The ranks are processes of tests/torch_rank_worker.py joined by gloo on
127.0.0.1, one CPU thread each, importing no JAX; the JAX references run in
this process, once per module.

Tolerances: the DP extract and the row-sharded FED compute each frame and
pixel as the unsharded path does, so they equal the port's one-rank path
bit for bit; against JAX the extract is held at the valid slots to valid
and descriptors equal and x within 1e-6 relative (an invalid slot's x is
each package's own filler; tests/test_parallel.py's 1e-5 absolute holds
between two paths of the JAX package, while the port's scale space rounds
in another order: 3.8e-5 at x ~ 90 px seen, a few float32 ULP), and the
FED to 1e-6.
The sharded BA adds partial Schur sums in another order: poses within 5e-4
(dense, tests/test_ba.py:101-105) and 1e-3 (CG, :170-172) of the port's
bundle_adjust and of JAX's bundle_adjust_sharded, rmse < 1e-3, and two runs
at one world size bit-equal.  run_incremental over 2 ranks: the same valid
points as one rank, camera centers within 1e-3, ATE < 0.05.  The pipeline
on JAX's per-frame draws: match counts equal to JAX's, pose inliers within
2 of JAX's (tests/test_pipeline_stage.py's gates)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.core.config import RansacConfig as JaxRansacConfig
from akaze_tpu.core.config import SfmConfig as JaxSfmConfig
from akaze_tpu.frontend.scale_space import diffusion_step as jax_diffusion_step
from akaze_tpu.parallel.mesh import extract_batch_sharded as jax_extract_batch_sharded
from akaze_tpu.parallel.mesh import make_mesh as jax_make_mesh
from akaze_tpu.parallel.mesh import total_valid_keypoints as jax_total_valid
from akaze_tpu.parallel.pipeline_stage import make_stage_mesh as jax_make_stage_mesh
from akaze_tpu.parallel.pipeline_stage import pipelined_stream as jax_pipelined_stream
from akaze_tpu.parallel.spatial import sharded_fed_cycle as jax_sharded_fed_cycle
from akaze_tpu.sfm import ba as J
from akaze_tpu.utils.synthetic import video_sequence
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import AkazeConfig, RansacConfig, SfmConfig
from akaze_tpu_torch.frontend.pipeline import extract_batch
from akaze_tpu_torch.frontend.scale_space import fed_cycle
from akaze_tpu_torch.parallel import collectives
from akaze_tpu_torch.parallel.mesh import make_mesh
from akaze_tpu_torch.parallel.pipeline_stage import sequential_stream
from akaze_tpu_torch.sfm import ba as T
from akaze_tpu_torch.sfm.incremental import run_incremental
from akaze_tpu_torch.sfm.metrics import ate_rmse, camera_centers
from test_ba import _synthetic_problem
from test_torch_sfm import _synthetic_sequence
from torch_port_helpers import run_ranks, trajectory_problem

torch.set_num_threads(2)

EXTRACT_CFG = dict(max_keypoints=128, per_level_candidates=32)


def _ba_arrays(problem) -> dict:
    return {f: np.asarray(getattr(problem, f)) for f in interop.BA_FIELDS}


# ---------------------------------------------------------------- DP extract


@pytest.fixture(scope="module")
def extract_case(tmp_path_factory):
    frames = np.asarray(video_sequence(8, 96, 128, seed=4), np.float32)
    got = run_ranks("extract", 2, tmp_path_factory.mktemp("extract"), {"frames": frames},
                    {"config": EXTRACT_CFG})
    cfg = JaxAkazeConfig(**EXTRACT_CFG)
    sharded = jax_extract_batch_sharded(frames, jax_make_mesh(8), cfg)
    want = {"valid": np.asarray(sharded.keypoints.valid), "x": np.asarray(sharded.keypoints.x),
            "descriptors": np.asarray(sharded.descriptors), "total_valid": int(jax_total_valid(sharded))}
    return frames, got, want


def test_extract_batch_sharded_equals_one_rank(extract_case):
    frames, got, _ = extract_case
    one = interop.features_to_numpy(extract_batch(frames, AkazeConfig(**EXTRACT_CFG), device="cpu"))
    assert sorted(one) == sorted(k for k in got if k != "total_valid")
    for k, v in one.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(got["total_valid"]) == int(one["valid"].sum()) > 0


def test_extract_batch_sharded_matches_jax(extract_case):
    _, got, want = extract_case
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    # Invalid slots hold each package's own filler; the valid ones are held.
    np.testing.assert_allclose(got["x"][v], want["x"][v], atol=0, rtol=1e-6)
    np.testing.assert_array_equal(got["descriptors"][v], want["descriptors"][v])
    assert int(got["total_valid"]) == want["total_valid"]


# ---------------------------------------------------------------- row-sharded FED


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fed_cycle_equals_fed_cycle_and_jax(world, tmp_path):
    """tests/test_parallel.py:19-30's input."""
    rng = np.random.default_rng(0)
    lt = rng.uniform(0, 1, (64, 80)).astype(np.float32)
    g = rng.uniform(0.1, 1, (64, 80)).astype(np.float32)
    taus = (0.25, 0.19, 0.1)
    got = run_ranks("fed", world, tmp_path, {"lt": lt, "g": g, "taus": np.asarray(taus)})["lt"]
    want = fed_cycle(torch.from_numpy(lt), torch.from_numpy(g), taus).numpy()
    np.testing.assert_array_equal(got, want)
    jax_out = np.asarray(jax_sharded_fed_cycle(jnp.asarray(lt), jnp.asarray(g), taus, jax_make_mesh(8)))
    np.testing.assert_allclose(got, jax_out, atol=1e-6, rtol=0)
    # And JAX's own unsharded steps.
    ref = jnp.asarray(lt)
    for tau in taus:
        ref = jax_diffusion_step(ref, jnp.asarray(g), tau)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- sharded BA


@pytest.mark.parametrize("case", ["dense", "cg"])
def test_bundle_adjust_sharded_matches_single_and_jax(case, tmp_path):
    if case == "dense":  # tests/test_ba.py:96-106
        problem = _synthetic_problem(P=64, seed=3)[0]
        iterations, tol = 8, 5e-4
    else:  # K = 72 > 64: the CG solve (tests/test_torch_ba.py's long-trajectory layout)
        problem = J.BAProblem(**{k: jnp.asarray(v) for k, v in trajectory_problem()[0].items()})
        iterations, tol = 4, 1e-3
    got = run_ranks("ba", 2, tmp_path, _ba_arrays(problem), {"iterations": iterations})
    assert bool(got["rerun_equal"])
    single = T.bundle_adjust(interop.ba_problem_from_numpy(_ba_arrays(problem), device="cpu"),
                             SfmConfig(ba_iterations=iterations))
    np.testing.assert_allclose(got["poses"], single.poses.numpy(), atol=tol, rtol=0)
    jax_sharded = J.bundle_adjust_sharded(problem, JaxSfmConfig(ba_iterations=iterations), jax_make_mesh(8))
    np.testing.assert_allclose(got["poses"], np.asarray(jax_sharded.poses), atol=tol, rtol=0)
    out = interop.ba_problem_from_numpy({**_ba_arrays(problem), "poses": got["poses"], "points": got["points"]},
                                        device="cpu")
    assert float(T.reprojection_rmse(out)) < (1e-3 if case == "dense" else 2e-3)


def test_bundle_adjust_sharded_on_one_rank_is_bundle_adjust():
    problem = interop.ba_problem_from_numpy(_ba_arrays(_synthetic_problem(P=64, seed=3)[0]), device="cpu")
    cfg = SfmConfig(ba_iterations=4)
    a = T.bundle_adjust(problem, cfg)
    b = T.bundle_adjust_sharded(problem, cfg, make_mesh(device="cpu"))
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)


def test_ba_problem_shards_round_trip():
    problem = interop.ba_problem_from_numpy(_ba_arrays(_synthetic_problem(P=64, seed=3)[0]), device="cpu")
    shards = interop.ba_problem_shards(problem, 4)
    assert [s.points.shape[0] for s in shards] == [16] * 4
    assert all(torch.equal(s.poses, problem.poses) and torch.equal(s.fixed, problem.fixed) for s in shards)
    back = interop.ba_problem_from_shards(shards)
    for f in interop.BA_FIELDS:
        assert torch.equal(getattr(back, f), getattr(problem, f)), f
    with pytest.raises(ValueError, match="divisible"):
        interop.ba_problem_shards(problem, 3)


# ---------------------------------------------------------------- run_incremental(mesh=)


def test_run_incremental_over_two_ranks(tmp_path):
    """tests/test_sfm.py:80-91's scene over 2 ranks, on JAX's draws."""
    observations, gt_poses, _ = _synthetic_sequence(K=10, noise=5e-4, seed=2)
    kwargs = dict(sconfig=SfmConfig(ba_iterations=8), rconfig=RansacConfig(num_iterations=256,
                                                                            inlier_threshold=5e-3))
    got = run_ranks("sfm", 2, tmp_path, extra={"observations": observations, "num_frames": 10, "kwargs": kwargs})
    one = run_incremental(observations, 10, device="cpu", draws=interop.jax_uniform, **kwargs)
    assert list(got["valid_tracks"]) == sorted(one.track_point) and len(got["points"]) == len(one.points) > 100
    centers = camera_centers(got["poses"])
    assert np.abs(centers - camera_centers(one.poses)).max() < 1e-3
    assert ate_rmse(centers, camera_centers(gt_poses)) < 0.05


# ---------------------------------------------------------------- pipeline


@pytest.fixture(scope="module")
def pipeline_case():
    """tests/test_pipeline_stage.py:39-58's frames and configs; JAX's
    pipelined_stream on its (stage, data) = (3, 2) mesh."""
    frames = np.asarray(video_sequence(6, 96, 128, seed=3), np.float32)
    h, w = frames.shape[1:]
    cfgs = dict(config=JaxAkazeConfig(max_keypoints=128, per_level_candidates=32, detector_threshold=1e-4),
                mconfig=JaxMatchConfig(max_distance=120), rconfig=JaxRansacConfig(num_iterations=64))
    intr = (float(w), float(w), w / 2.0, h / 2.0)
    want = jax_pipelined_stream(frames, jax_make_stage_mesh(jax.devices(), data=2), **cfgs, microbatch=2,
                                intr=intr)
    fields = {k: dataclasses.asdict(v) for k, v in cfgs.items()}
    fields["config"]["diffusivity"] = fields["config"]["diffusivity"].value
    return frames, fields, intr, want


def _check_pipeline(got, want):
    np.testing.assert_array_equal(got["match_counts"], want["match_counts"])
    diff = np.abs(got["pose_inliers"] - want["pose_inliers"])
    assert diff.max() <= 2, (got["pose_inliers"], want["pose_inliers"])
    assert (got["pose_inliers"][want["pose_inliers"] >= 8] >= 6).all()


@pytest.mark.parametrize("data", [1, 2])
def test_pipelined_stream_matches_jax(data, pipeline_case, tmp_path):
    frames, fields, intr, want = pipeline_case
    got = run_ranks("pipeline", 3 * data, tmp_path, {"frames": frames},
                    {**fields, "microbatch": 2, "intr": intr})
    _check_pipeline(got, want)


def test_sequential_stream_matches_jax(pipeline_case):
    frames, fields, intr, want = pipeline_case
    cfgs = {k: interop.config_from_fields(v) for k, v in fields.items()}
    seed = cfgs["rconfig"].seed
    got = sequential_stream(frames, **cfgs, intr=intr, device="cpu",
                            draws=lambda f, shape: interop.jax_uniform(seed, shape, fold_in=f))
    _check_pipeline(got, want)


# ---------------------------------------------------------------- contracts


def test_jax_uniform_fold_in_equals_jax():
    for seed, fold in ((0, 0), (0, 7), (5, 123456), (2**32 - 1, 2**32 - 1)):
        want = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), fold), (3, 17)))
        np.testing.assert_array_equal(interop.jax_uniform(seed, (3, 17), fold_in=fold), want)
    with pytest.raises(ValueError, match="fold_in"):
        interop.jax_uniform(0, (2,), fold_in=-1)


def test_exact_collectives_in_a_world_of_one():
    """Without a process group a mesh has one rank and the collectives
    return their input; bit patterns survive packing (-0.0, NaN payloads,
    bools, odd byte counts)."""
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
    x = torch.tensor([-0.0, float("nan"), 1.5], dtype=torch.float32)
    b = torch.tensor([True, False, True])
    gx, gb = collectives.all_gather([x, b], mesh)
    assert torch.equal(gx.view(torch.int32), x.view(torch.int32)) and torch.equal(gb, b)
    assert torch.equal(collectives.all_sum(x, mesh).view(torch.int32), x.view(torch.int32))
    received = collectives.exchange([], [x], mesh)
    assert torch.equal(received[0][0], torch.zeros(3))
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        collectives.rank_rows(7, collectives.Mesh((2,), ("data",), torch.device("cpu"), (0,), (None,)))
