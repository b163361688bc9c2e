"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

Imports neither JAX nor the JAX package, so the GPU tests that use it run
on a machine without JAX."""

from __future__ import annotations

import os
import pickle
import select
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu_torch.kernels import fed


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row Hamming distance of (..., W) 32-bit descriptor words."""
    a = np.ascontiguousarray(a).view(np.uint32)
    b = np.ascontiguousarray(b).view(np.uint32)
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1)


#: tests/test_two_view_bound.py's pose error bound on multi_plane_pair.
ROT_BOUND_DEG, TDIR_BOUND_DEG = 1.5, 6.0


def rot_deg(Ra, Rb) -> float:
    """Angle of the rotation between two (3, 3) rotations, in degrees."""
    Ra, Rb = np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def dir_deg(ta, tb) -> float:
    """Angle between two directions, sign included, in degrees."""
    ta, tb = np.asarray(ta, np.float64), np.asarray(tb, np.float64)
    c = ta @ tb / (np.linalg.norm(ta) * np.linalg.norm(tb))
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def tdir_err_deg(t_est, t_gt) -> float:
    """The reference bound's t-direction error (sign-blind, as
    tests/test_two_view_bound.py measures it)."""
    t_est, t_gt = np.asarray(t_est, np.float64), np.asarray(t_gt, np.float64)
    return float(np.degrees(np.arccos(np.clip(abs(t_est @ t_gt), -1, 1))))


def assert_same_pose(ref, got):
    """Two two-view results (R, t, num_inliers; any array type) hold the same
    pose: R within 0.05 deg, t-direction (sign included) within 0.2 deg,
    inlier counts within max(1, 1 %)."""
    host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert rot_deg(host(ref.R), host(got.R)) <= 0.05
    assert dir_deg(host(ref.t), host(got.t)) <= 0.2
    n_r, n_g = int(ref.num_inliers), int(got.num_inliers)
    assert abs(n_r - n_g) <= max(1, 0.01 * n_r), (n_r, n_g)


def wrapped_angle_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture
def cuda():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def pair_keypoints(ref: dict, got: dict, tol: float = 0.01):
    """Pair each valid reference keypoint with a valid port keypoint of the
    same class_id within `tol` px.  ref/got: dicts of one frame's numpy
    keypoint fields plus "descriptors".  Returns (paired fraction, Hamming
    distances of the pairs)."""
    rv = np.nonzero(ref["valid"])[0]
    gv = got["valid"]
    hams = []
    for i in rv:
        c = np.nonzero(gv & (got["class_id"] == ref["class_id"][i]))[0]
        if len(c) == 0:
            continue
        d = np.hypot(got["x"][c] - ref["x"][i], got["y"][c] - ref["y"][i])
        if d.min() < tol:
            hams.append(int(hamming(ref["descriptors"][i], got["descriptors"][c[d.argmin()]])))
    return len(hams) / max(1, len(rv)), np.asarray(hams)


def custom_plan(specs, h: int, w: int, first: bool, tile, fuse: bool) -> tuple:
    """A level-chain plan that `fed.level_plan` does not choose: every level
    of the octave `specs` on (h, w) planes run on `tile`, its detect cascade
    in the level's one launch (fuse) or in a launch of its own, each halo as
    small as its stages allow."""
    plans = []
    for i, spec in enumerate(specs):
        n, reach = len(spec.taus), 2 * spec.sigma_size + 1
        detect = fed._launch("detect", h, w, tile, reach)
        if first and i == 0:
            launches = (detect,)
        elif fuse:
            launches = (fed._launch("level", h, w, tile, max(n + 3, reach + 2), n),)
        else:
            launches = (fed._launch("diffuse", h, w, tile, n + 3, n), detect)
        plans.append(fed.LevelPlan("tiled", launches))
    return tuple(plans)


def match_descriptors(rng, n):
    """n random (n, 16) uint32 descriptors."""
    d = rng.integers(0, 2**32, size=(n, 16), dtype=np.uint32)
    d[:, -1] &= (1 << 6) - 1  # 486 bits used, as AKAZE's descriptors
    return d


def match_case(ka, kb, mask):
    """Random descriptors with exact matches, and duplicate rows and columns
    placed across lanes, warp blocks and tiles, so that ties cross every
    boundary of the decomposition."""
    rng = np.random.default_rng(ka * 7 + kb)
    a, b = match_descriptors(rng, ka), match_descriptors(rng, kb)
    n = min(ka, kb) // 3
    b[:n] = a[:n]
    for src, dst in ((0, 2), (1, 9), (3, 64), (5, 67), (6, 130), (2, 200)):
        if dst < kb:
            b[dst] = b[src]
        if dst < ka:
            a[dst] = a[src]
    if mask == "prefix_holes":  # as the main path: a valid prefix with holes
        va, vb = np.arange(ka) < int(0.8 * ka) + 1, np.arange(kb) < int(0.7 * kb) + 1
        va[3::11] = False
        vb[5::7] = False
    else:
        va, vb = rng.random(ka) > 0.15, rng.random(kb) > 0.15
        if mask == "invalid_a":
            va[:] = False
        elif mask == "invalid_b":
            vb[:] = False
    return a, va, b, vb


#: (Ka, Kb, mask) of the match cases: Ka, Kb not multiples of 16, 8, 64 or
#: 128 (1 included), Kb over one column tile, all-invalid A or B.
MATCH_CASES = [
    (1, 1, "random"),
    (1, 300, "prefix_holes"),
    (77, 1, "random"),
    (130, 263, "prefix_holes"),
    (200, 1100, "prefix_holes"),
    (96, 520, "random"),
    (130, 263, "invalid_a"),
    (70, 140, "invalid_b"),
]


def trajectory_problem(K=72, P=320, Q=4, pose_err=0.01, pt_err=0.05, seed=5):
    """tests/test_ba.py's `_long_trajectory_problem` without observation
    noise, in numpy: cameras slide along x with a slow yaw, each point in
    front of the middle of its Q consecutive cameras, poses 0 and 1 fixed.
    Returns (the problem's fields as numpy arrays, the true poses)."""
    from akaze_tpu_torch.utils.synthetic import _rotvec_to_matrix_np

    rng = np.random.default_rng(seed)
    poses = np.zeros((K, 6))
    poses[:, 1] = 0.003 * np.arange(K)
    poses[:, 3] = -0.15 * np.arange(K)
    poses[:, 4] = 0.01 * np.sin(0.1 * np.arange(K))
    rots = [_rotvec_to_matrix_np(p[:3]) for p in poses]
    starts = rng.integers(0, K - Q + 1, P)
    obs_cam = (starts[:, None] + np.arange(Q)[None, :]).astype(np.int32)
    pts = np.zeros((P, 3))
    obs_uv = np.zeros((P, Q, 2), np.float32)
    for p in range(P):
        mid = starts[p] + Q // 2
        local = np.array([rng.uniform(-2, 2), rng.uniform(-1.5, 1.5), rng.uniform(6, 14)])
        pts[p] = rots[mid].T @ (local - poses[mid, 3:])
        for q in range(Q):
            xc = rots[obs_cam[p, q]] @ pts[p] + poses[obs_cam[p, q], 3:]
            obs_uv[p, q] = xc[:2] / xc[2]
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    init_poses = poses.copy()
    init_poses[2:] += rng.normal(0, pose_err, (K - 2, 6))
    init_pts = pts + rng.normal(0, pt_err, pts.shape)
    fields = dict(poses=init_poses.astype(np.float32), points=init_pts.astype(np.float32), obs_cam=obs_cam,
                  obs_uv=obs_uv, obs_valid=np.ones((P, Q), bool), fixed=fixed)
    return fields, poses


# ---------------------------------------------------------------- rank processes

RANK_WORKER = Path(__file__).resolve().parent / "torch_rank_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(job: str, world: int, workdir: Path, port: int | None = None, ranks=None) -> list:
    """Start `tests/torch_rank_worker.py JOB` as ranks `ranks` (default all)
    of a world of `world`, stdout and stderr piped together."""
    port = port or free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_"))}
    return [subprocess.Popen([sys.executable, "-u", str(RANK_WORKER), job, str(r), str(world), str(port),
                              str(workdir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in (range(world) if ranks is None else ranks)]


def reap(procs) -> None:
    """Kill and reap every process still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        if p.stdout is not None:
            p.stdout.close()


def await_line(proc, needle: str, timeout: float) -> bool:
    """Whether `needle` appears in a line of proc's stdout within `timeout`
    seconds; select() gates each read, so a silent child cannot block past
    the deadline."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                return False
            continue
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            return False
        if needle in line:
            return True
    return False


def run_ranks(job: str, world: int, workdir: Path, arrays: dict | None = None, extra: dict | None = None,
              timeout: float = 120.0) -> dict:
    """Write the job's inputs to `workdir`, run `world` ranks of it to their
    end within `timeout` seconds (all killed on failure) and return rank 0's
    out.npz as a dict."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if arrays is not None:
        np.savez(workdir / "in.npz", **arrays)
    if extra is not None:
        (workdir / "in.pkl").write_bytes(pickle.dumps(extra))
    procs = spawn_ranks(job, world, workdir)
    deadline = time.time() + timeout
    try:
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(out)
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0 and "DONE" in log, f"rank {r} of {job} failed:\n{log[-3000:]}"
    finally:
        reap(procs)
    with np.load(workdir / "out.npz") as f:
        return dict(f)
