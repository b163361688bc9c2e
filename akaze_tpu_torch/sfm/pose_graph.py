"""Pose-graph optimization of the port: Gauss-Newton over SE(3)
relative-pose residuals (counterpart of the JAX package's
`akaze_tpu/sfm/pose_graph.py`, same residual, weights and solve).

Fixed-shape: up to E edges with a validity mask; the 6K-parameter normal
system is dense, its (6E, 6K) Jacobian by forward-mode autodiff
(`torch.func.jacfwd`, as the reference's `jacfwd`), solved with damping.

Convention: poses are camera-from-world [rotvec | trans] (as in `sfm.ba`);
edge (i, j) measures T_ij = T_i @ T_j^{-1} (cam_i-from-cam_j).  Residual =
log(T_meas^{-1} T_i T_j^{-1}) as a 6-vector.  Importing this module pins
float32 matrix products on the GPU (no TF32).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd

from akaze_tpu_torch.sfm.rotations import matrix_to_rotvec, rotvec_to_matrix
from akaze_tpu_torch.utils.profiling import check_no_nan, span

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class PoseGraph:
    """poses (K, 6); edge_i / edge_j (E,) int64; rel (E, 6) measured
    cam_i-from-cam_j [rotvec | trans]; valid (E,) bool; fixed (K,) bool;
    weight (E,) f32 information weights (1 / sigma per edge; None =
    unweighted).  Odometry edges carry BA-polished local poses (per-edge
    error ~1e-4), monocular closure edges two-view noise (~2e-3 rad): the
    weights keep a closure's own noise from pulling a low-drift
    trajectory."""

    poses: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    rel: torch.Tensor
    valid: torch.Tensor
    fixed: torch.Tensor
    weight: torch.Tensor | None = None


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3), written out elementwise."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def compose(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """T_a @ T_b for [rotvec | trans] poses (broadcasting on leading dims)."""
    ra = rotvec_to_matrix(pose_a[..., :3])
    rb = rotvec_to_matrix(pose_b[..., :3])
    t = (ra * pose_b[..., None, 3:]).sum(-1) + pose_a[..., 3:]
    return torch.cat([matrix_to_rotvec(_matmul3(ra, rb)), t], dim=-1)


def invert(pose: torch.Tensor) -> torch.Tensor:
    r = rotvec_to_matrix(pose[..., :3])
    t = -(r * pose[..., 3:, None]).sum(-2)  # -R^T t
    return torch.cat([-pose[..., :3], t], dim=-1)


def relative(pose_i: torch.Tensor, pose_j: torch.Tensor) -> torch.Tensor:
    """cam_i-from-cam_j: T_i @ T_j^{-1}."""
    return compose(pose_i, invert(pose_j))


def _residuals(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """(E, 6) log-residuals, zeroed on invalid edges, information-scaled."""
    rel_est = relative(poses[graph.edge_i], poses[graph.edge_j])
    err = compose(invert(graph.rel), rel_est)  # identity when consistent
    err = err * graph.valid[:, None]
    if graph.weight is not None:
        err = err * graph.weight[:, None]
    return err


def _with_value(f):
    """f(...) -> (f, f): `jacfwd(_with_value(f), has_aux=True)` gives the
    Jacobian and the value from one forward pass."""
    def g(*args):
        out = f(*args)
        return out, out
    return g


def optimize_pose_graph(graph: PoseGraph, iterations: int = 10, damping: float = 1e-6) -> PoseGraph:
    """Damped Gauss-Newton on the device of the graph's tensors, fixed poses
    pinned by parameter masking; a fixed iteration count, no host read."""
    K = graph.poses.shape[0]
    graph = dataclasses.replace(graph, edge_i=graph.edge_i.long(), edge_j=graph.edge_j.long())
    mask = torch.logical_not(graph.fixed)[:, None].expand(K, 6).reshape(-1).to(graph.poses.dtype)
    eye = torch.eye(6 * K, dtype=graph.poses.dtype, device=graph.poses.device)
    pinned = torch.diag(1.0 - mask)

    def flat_res(p_flat):
        return _residuals(p_flat.reshape(K, 6), graph).reshape(-1)

    jac = jacfwd(_with_value(flat_res), has_aux=True)
    p = graph.poses.reshape(-1)
    for _ in range(iterations):
        jmat, r = jac(p)  # (6E, 6K), (6E,)
        jmat = jmat * mask[None, :]
        h = jmat.T @ jmat + damping * eye + pinned
        g = jmat.T @ r
        with span("linalg", p.device):
            delta = -torch.linalg.solve_ex(h, g[:, None], check_errors=False).result[:, 0] * mask
        p = p + delta
    poses = p.reshape(K, 6)
    check_no_nan("optimize_pose_graph", poses)
    return dataclasses.replace(graph, poses=poses)
