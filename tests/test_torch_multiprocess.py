"""The port's distributed runtime across real processes: the counterparts
of tests/test_multiprocess.py and tests/test_fault_injection.py, and the
sfm CLI's --mesh under torch.distributed.run.

Ranks are processes of tests/torch_rank_worker.py (gloo on 127.0.0.1, one
CPU thread each, no JAX):
  1. a 2-rank sharded BA equals the single-process result (two rounds of 6
     LM iterations with a checkpoint between them, tests/test_ba.py's
     _synthetic_problem(P=64, seed=3));
  2. one of the two ranks is SIGKILLed after round 1: the survivor cannot
     finish, and a fresh process that initializes a world of one resumes
     from the checkpoint and lands on the uninterrupted poses;
  3. a 3-rank world loses one rank after round 1, and the two survivors
     initialize a world of two and finish from the checkpoint;
  4. an SfM worker SIGKILLed between windows resumes from its last
     checkpoint in this process and lands on the uninterrupted trajectory;
  5. `torch.distributed.run --nproc-per-node 2 -m akaze_tpu_torch.cli.sfm
     ... --mesh 2` equals the --mesh 0 run (the same tracks, points and
     closures, camera centers within 1e-3), and a --mesh other than the
     world size is refused.
Every wait has its own deadline and every child is killed and reaped on
failure, so a hung rank fails its test.  Tolerances are the JAX tests':
poses within 1e-3 (1-3), 5e-2 (4)."""

import json
import os
import pickle
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu_torch import interop
from akaze_tpu_torch.cli import sfm as cli_sfm
from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
from akaze_tpu_torch.sfm import ba as T
from akaze_tpu_torch.sfm.checkpoint import load_checkpoint
from akaze_tpu_torch.sfm.incremental import run_incremental
from akaze_tpu_torch.utils.synthetic import video_sequence
from test_ba import _synthetic_problem
from test_torch_sfm import _synthetic_sequence
from torch_port_helpers import await_line, reap, run_ranks, spawn_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _problem_arrays(npts: int) -> dict:
    problem = _synthetic_problem(P=npts, seed=3)[0]
    return {f: np.asarray(getattr(problem, f)) for f in interop.BA_FIELDS}


def _single_process_reference(arrays: dict) -> np.ndarray:
    cfg = SfmConfig(ba_iterations=6)
    problem = interop.ba_problem_from_numpy(arrays, device="cpu")
    r1 = T.bundle_adjust(problem, cfg)
    return T.bundle_adjust(problem.replace(poses=r1.poses, points=r1.points), cfg).poses.numpy()


@pytest.fixture(scope="module")
def case_64():
    arrays = _problem_arrays(64)
    return arrays, _single_process_reference(arrays)


@pytest.fixture(scope="module")
def case_48():
    """P = 48 splits over the world of three and over the two survivors."""
    arrays = _problem_arrays(48)
    return arrays, _single_process_reference(arrays)


def test_two_process_sharded_ba_matches_single(tmp_path, case_64):
    arrays, reference = case_64
    got = run_ranks("pair", 2, tmp_path, arrays)
    np.testing.assert_allclose(got["poses"], reference, atol=1e-3, rtol=0)


def _crash_and_check(tmp_path, job: str, world: int, victim: int):
    """Run `job` on `world` ranks, SIGKILL rank `victim` once round 1 has
    written its checkpoint, and check that no survivor finishes."""
    procs = spawn_ranks(job, world, tmp_path)
    try:
        assert await_line(procs[0], "ROUND1 done", timeout=120), "round 1 never completed"
        assert (tmp_path / "ckpt.npz").exists()
        os.kill(procs[victim].pid, signal.SIGKILL)
        # The survivors' round-2 collectives lost a peer: they fail (gloo
        # sees the closed connection) or hang until reaped; none finishes.
        deadline = time.time() + 30
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        assert not (tmp_path / "out.npz").exists(), "a survivor completed despite a dead peer"
        assert procs[victim].returncode == -signal.SIGKILL
    finally:
        reap(procs)


def test_sigkill_peer_then_survivor_resumes(tmp_path, case_64):
    arrays, reference = case_64
    np.savez(tmp_path / "in.npz", **arrays)
    _crash_and_check(tmp_path, "pair_crash", 2, victim=1)
    # The survivor's respawn: a fresh process group of one on a new port.
    got = run_ranks("solo", 1, tmp_path)
    np.testing.assert_allclose(got["poses"], reference, atol=1e-3, rtol=0)


def test_three_process_loss_reforms_two_survivor_world(tmp_path, case_48):
    arrays, reference = case_48
    np.savez(tmp_path / "in.npz", **arrays)
    _crash_and_check(tmp_path, "trio_crash", 3, victim=2)
    got = run_ranks("duo_resume", 2, tmp_path)
    np.testing.assert_allclose(got["poses"], reference, atol=1e-3, rtol=0)


def test_sfm_worker_sigkill_and_resume(tmp_path):
    """tests/test_fault_injection.py on the port: its K = 14 scene, killed
    after the first window's checkpoint, resumed here."""
    observations, _, _ = _synthetic_sequence(K=14, noise=5e-4, seed=7)
    (tmp_path / "in.pkl").write_bytes(pickle.dumps({"observations": observations}))
    procs = spawn_ranks("sfm_paced", 1, tmp_path)
    try:
        assert await_line(procs[0], "WINDOW", timeout=120), "the worker finished no window"
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait(timeout=30)
        assert procs[0].returncode == -signal.SIGKILL
    finally:
        reap(procs)
    ckpt = load_checkpoint(tmp_path / "map.npz")
    assert 0 < ckpt.next_keyframe < 14  # killed mid-run
    scfg, rcfg = SfmConfig(ba_iterations=6), RansacConfig(num_iterations=128, inlier_threshold=5e-3)
    resumed = run_incremental(observations, 14, scfg, rcfg, ba_every=3, resume=ckpt, device="cpu")
    full = run_incremental(observations, 14, scfg, rcfg, ba_every=3, device="cpu")
    np.testing.assert_allclose(resumed.poses, full.poses, atol=5e-2)


_CLI = ["--batch", "4", "--ba-iterations", "4", "--octaves", "3", "--max-keypoints", "128", "--threshold", "1e-4",
        "--device", "cpu"]


def _torchrun(nproc: int, args: list, timeout: float = 150.0) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_"))}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                           str(nproc), "-m", "akaze_tpu_torch.cli.sfm", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_sfm_mesh_2_equals_mesh_0(tmp_path):
    fp = tmp_path / "frames.npy"
    np.save(fp, video_sequence(8, 96, 128, seed=5))
    ref_out = tmp_path / "mesh0.json"
    assert cli_sfm.main([str(fp), "-o", str(ref_out), *_CLI]) == 0
    out = tmp_path / "mesh2.json"
    run = _torchrun(2, [str(fp), "-o", str(out), "--mesh", "2", *_CLI])
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    got, ref = json.loads(out.read_text()), json.loads(ref_out.read_text())
    for key in ("num_frames", "num_tracks", "num_points", "num_loop_closures"):
        assert got[key] == ref[key], key
    assert ref["num_points"] > 50
    np.testing.assert_allclose(got["camera_centers"], ref["camera_centers"], atol=1e-3, rtol=0)


def test_cli_sfm_refuses_mesh_other_than_world(tmp_path):
    run = _torchrun(2, [str(tmp_path / "none.npy"), "-o", str(tmp_path / "o.json"), "--mesh", "3", *_CLI])
    assert run.returncode != 0
    assert "--mesh 3 shards over 3 ranks and this run has 2" in run.stderr
    assert not (tmp_path / "o.json").exists()
