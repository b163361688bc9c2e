"""Trajectory metrics: ATE with Umeyama similarity alignment (own copy of
the JAX package's `akaze_tpu/sfm/metrics.py`, numpy)."""

from __future__ import annotations

import numpy as np
import torch


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Similarity (s, R, t) minimizing ||gt - (s R est + t)||; est/gt (N, 3)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    r = u @ s_fix @ vt
    if with_scale:
        var_e = (xe**2).sum() / est.shape[0]
        scale = float(np.trace(np.diag(d) @ s_fix) / max(var_e, 1e-12))
    else:
        scale = 1.0
    t = mu_g - scale * r @ mu_e
    return scale, r, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE) after similarity alignment (the
    monocular scale is unobservable)."""
    s, r, t = umeyama_align(est_positions, gt_positions, with_scale)
    aligned = (s * (r @ est_positions.T)).T + t
    return float(np.sqrt(((aligned - gt_positions) ** 2).sum(axis=1).mean()))


def camera_centers(poses: np.ndarray) -> np.ndarray:
    """Camera centers C = -R^T t from (K, 6) camera-from-world poses (the
    rotations by the port's float32 Rodrigues, on the CPU)."""
    from akaze_tpu_torch.sfm.rotations import rotvec_to_matrix

    r = rotvec_to_matrix(torch.from_numpy(np.array(poses[:, :3], np.float32))).numpy()
    return -np.einsum("kji,kj->ki", r, poses[:, 3:])
