"""Bundle adjustment of the port: Levenberg-Marquardt with the Schur
complement onto the poses (counterpart of the JAX package's
`akaze_tpu/sfm/ba.py`, same problem layout, damping and solvers).

  * Fixed-shape problem: poses (K, 6) [rotvec | trans], points (P, 3) and
    a dense (P, Q) observation table (invalid slots carry zero weight).
  * Per-observation 2x9 Jacobians in closed form (`project`), the
    derivative the reference's `jacfwd` takes, written out elementwise.
  * The reductions over observations are products with a one-hot (P, Q, K)
    camera table, never a scatter-add: each camera block and the Schur
    term S = U - sum_p Y_p W_p^T come out of matrix products whose
    summation order is fixed, so two runs on the card give the same bits
    (an atomic `index_add_` adds in no fixed order, and the LM accept test
    `new_cost < cost` would then flip between runs).  S is one (6K, 3P) x
    (3P, 6K) float32 product of the point blocks scattered into dense camera
    rows.
  * Reduced pose system solved dense (6K x 6K) up to K = 64, by
    block-Jacobi-preconditioned CG with 120 fixed iterations past that.
  * The LM loop is branchless: a fixed iteration count, accept/reject with
    `torch.where`, no value read back to the host.
  * Distributed BA (`bundle_adjust_sharded`): the points and their
    observations are split over the ranks of a mesh axis and the poses are
    replicated.  Each rank builds its partial S, rhs and camera blocks U
    and its partial costs; these are summed over the ranks before the
    damping and gauge fixing, in rank order, so every rank solves the same
    pose system to the same bits.  Point updates stay on their rank.

`bundle_adjust` runs on the device of the problem's tensors (see
`interop.ba_problem_from_numpy` to place one).  Importing this module pins
float32 matrix products on the GPU (no TF32).
"""

from __future__ import annotations

import dataclasses

import torch

from akaze_tpu_torch.core.config import SfmConfig
from akaze_tpu_torch.sfm.rotations import rotate_jacobian, rotvec_to_matrix
from akaze_tpu_torch.utils.profiling import check_no_nan, span

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: The largest pose count solved dense; CG past it.
DENSE_MAX_POSES = 64
CG_ITERATIONS = 120


@dataclasses.dataclass
class BAProblem:
    """Fixed-shape BA state and observations, tensors on one device.

    poses: (K, 6) f32 camera-from-world [rotvec, translation]
    points: (P, 3) f32 world points
    obs_cam: (P, Q) int64 camera index per observation slot
    obs_uv: (P, Q, 2) f32 normalized image coords
    obs_valid: (P, Q) bool
    fixed: (K,) bool, gauge-fixed poses (updates forced to zero)
    """

    poses: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor
    obs_uv: torch.Tensor
    obs_valid: torch.Tensor
    fixed: torch.Tensor

    def replace(self, **changes) -> "BAProblem":
        return dataclasses.replace(self, **changes)

    def rows(self, sl: slice) -> "BAProblem":
        """The problem cut to the point rows `sl` (points and their
        observations), with every pose."""
        return self.replace(**{f: getattr(self, f)[sl] for f in POINT_FIELDS})


#: The fields indexed by point row; the other two (poses, fixed) by camera.
POINT_FIELDS = ("points", "obs_cam", "obs_uv", "obs_valid")


def project(poses: torch.Tensor, points: torch.Tensor, uv: torch.Tensor, jacobians: bool = True):
    """Reprojection residuals (..., 2) of points (..., 3) seen by poses
    (..., 6) at normalized uv (..., 2), and with jacobians=True their
    Jacobians (..., 2, 6) by the pose and (..., 2, 3) by the point, closed
    form (`rotate_jacobian`; a depth within 1e-9 of 0 is held at 1e-9 and
    differentiates as a constant, as the reference's `jnp.where` does)."""
    rot = rotvec_to_matrix(poses[..., :3])
    xc = (rot * points[..., None, :]).sum(-1) + poses[..., 3:]
    near = xc[..., 2].abs() < 1e-9
    z = torch.where(near, 1e-9, xc[..., 2])
    res = torch.stack([xc[..., 0] / z - uv[..., 0], xc[..., 1] / z - uv[..., 1]], dim=-1)
    if not jacobians:
        return res
    zero = torch.zeros_like(z)
    inv = 1.0 / z
    dz = lambda x: torch.where(near, zero, -x / (z * z))
    d = torch.stack([torch.stack([inv, zero, dz(xc[..., 0])], dim=-1),
                     torch.stack([zero, inv, dz(xc[..., 1])], dim=-1)], dim=-2)  # d res / d xc
    times = lambda m: (d[..., :, :, None] * m[..., None, :, :]).sum(-2)
    jc = torch.cat([times(rotate_jacobian(poses[..., :3], points)), d], dim=-1)
    return res, jc, times(rot)


def _observed(problem: BAProblem):
    """Per-slot pose, point and observation, flattened to (P * Q, ...)."""
    P, Q = problem.obs_cam.shape
    poses_o = problem.poses[problem.obs_cam.reshape(-1)]
    pts_o = problem.points[:, None, :].expand(P, Q, 3).reshape(-1, 3)
    return poses_o, pts_o, problem.obs_uv.reshape(-1, 2)


def _robust_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS weight per observation: min(1, delta / |r|)."""
    norm = torch.sqrt((r * r).sum(-1) + 1e-12)
    return torch.clamp(delta / norm, max=1.0)


def _linearize(problem: BAProblem, delta: float):
    """Per-observation residuals and Jacobians, sqrt-Huber weighted:
    r (P, Q, 2), jc (P, Q, 2, 6), jp (P, Q, 2, 3)."""
    P, Q = problem.obs_cam.shape
    r, jc, jp = project(*_observed(problem))
    r, jc, jp = r.reshape(P, Q, 2), jc.reshape(P, Q, 2, 6), jp.reshape(P, Q, 2, 3)
    w = _robust_weight(r, delta) * problem.obs_valid
    sw = torch.sqrt(w)[..., None]
    return r * sw, jc * sw[..., None], jp * sw[..., None]


def _cost(problem: BAProblem, delta: float) -> torch.Tensor:
    """Total Huber cost over valid observations (0-d tensor)."""
    r = project(*_observed(problem), jacobians=False).reshape(*problem.obs_cam.shape, 2)
    n2 = (r * r).sum(-1)
    n = torch.sqrt(n2 + 1e-12)
    huber = torch.where(n <= delta, 0.5 * n2, delta * (n - 0.5 * delta))
    return (huber * problem.obs_valid).sum()


def _camera_onehot(problem: BAProblem) -> torch.Tensor:
    """(P, Q, K) float32: 1 where slot (p, q) observes camera k."""
    K = problem.poses.shape[0]
    cams = torch.arange(K, device=problem.obs_cam.device)
    return (problem.obs_cam[..., None] == cams).to(problem.poses.dtype)


def _add_diagonal_blocks(s: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """s (K, K, 6, 6) with blocks (K, 6, 6) added on its block diagonal."""
    K = s.shape[0]
    idx = torch.arange(K, device=s.device)
    s = s.clone()
    s[idx, idx] = s[idx, idx] + blocks
    return s


def _schur_system(problem: BAProblem, lam: torch.Tensor, config: SfmConfig, reduce=None):
    """The reduced pose system (S (K, K, 6, 6), rhs (K, 6)) and the point
    side factors (vinv, w_blk, g_p) for the back-substitution.  With
    `reduce` (a sum over the ranks that hold the other points), the partial
    S, rhs and U are summed before the damping and gauge fixing."""
    K = problem.poses.shape[0]
    P, Q = problem.obs_cam.shape
    r, jc, jp = _linearize(problem, config.huber_delta)
    onehot = _camera_onehot(problem)  # (P, Q, K)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)

    # Camera blocks: sums over each camera's slots as one-hot products.
    u = torch.einsum("pqk,pqx->kx", onehot, torch.einsum("pqri,pqrj->pqij", jc, jc).reshape(P, Q, 36))
    u = u.reshape(K, 6, 6)
    g_c = torch.einsum("pqk,pqi->ki", onehot, torch.einsum("pqri,pqr->pqi", jc, r))
    # Point blocks.
    v = torch.einsum("pqri,pqrj->pij", jp, jp)  # (P, 3, 3)
    g_p = torch.einsum("pqri,pqr->pi", jp, r)  # (P, 3)
    w_blk = torch.einsum("pqri,pqrj->pqij", jc, jp)  # (P, Q, 6, 3)

    # Marquardt damping on the point blocks, then invert.
    v_d = v + lam * eye3 * torch.clamp(torch.diagonal(v, dim1=-2, dim2=-1).mean(-1)[:, None, None], min=1e-8)
    with span("linalg", v_d.device):
        vinv = torch.linalg.inv_ex(v_d + 1e-9 * eye3, check_errors=False).inverse  # (P, 3, 3)
    y = torch.einsum("pqij,pjk->pqik", w_blk, vinv)  # (P, Q, 6, 3)

    # Schur term: the point blocks of y and w_blk scattered into dense
    # camera rows by the one-hot table, then one product over all points.
    y_rows = torch.einsum("pqk,pqx->kpx", onehot, y.reshape(P, Q, 18)).reshape(K, P, 6, 3)
    w_rows = torch.einsum("pqk,pqx->kpx", onehot, w_blk.reshape(P, Q, 18)).reshape(K, P, 6, 3)
    a = y_rows.permute(0, 2, 1, 3).reshape(6 * K, 3 * P)
    b = w_rows.permute(0, 2, 1, 3).reshape(6 * K, 3 * P)
    s = -(a @ b.T).reshape(K, 6, K, 6).permute(0, 2, 1, 3)
    s = _add_diagonal_blocks(s, u)

    y_gp = torch.einsum("pqik,pk->pqi", y, g_p)
    rhs = -(g_c - torch.einsum("pqk,pqi->ki", onehot, y_gp))  # (K, 6)
    if reduce is not None:
        parts = (s, rhs, u)
        total = reduce(torch.cat([x.reshape(-1) for x in parts])).split([x.numel() for x in parts])
        s, rhs, u = (t.reshape(x.shape) for t, x in zip(total, parts))

    # Marquardt damping and gauge fixing on the pose system.
    damp = lam * torch.clamp(torch.diagonal(u, dim1=-2, dim2=-1).mean(-1), min=1e-8)
    s = _add_diagonal_blocks(s, damp[:, None, None] * eye6 + 1e-9 * eye6)
    fixed = problem.fixed
    mask_k = torch.logical_not(fixed).to(s.dtype)
    s = s * mask_k[:, None, None, None] * mask_k[None, :, None, None]
    s = _add_diagonal_blocks(s, fixed.to(s.dtype)[:, None, None] * eye6)
    rhs = rhs * mask_k[:, None]
    return s, rhs, vinv, w_blk, g_p


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, 0 where den == 0."""
    return torch.where(den == 0, 0.0, num / torch.where(den == 0, 1.0, den))


def _solve_pose_system(s: torch.Tensor, rhs: torch.Tensor, iters: int = CG_ITERATIONS) -> torch.Tensor:
    """Block-Jacobi-preconditioned conjugate gradients on the reduced pose
    system (S is symmetric positive definite: a damped Schur complement
    with identity rows on the gauge-fixed poses), a fixed iteration count."""
    K = rhs.shape[0]
    idx = torch.arange(K, device=s.device)
    eye6 = torch.eye(6, dtype=s.dtype, device=s.device)
    with span("linalg", s.device):
        minv = torch.linalg.inv_ex(s[idx, idx] + 1e-12 * eye6, check_errors=False).inverse  # (K, 6, 6)
    a = s.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    flat = lambda x: x.reshape(-1)

    def precond(x):
        return (minv @ x[..., None])[..., 0]

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        ap = (a @ flat(p)).reshape(K, 6)
        alpha = _safe_ratio(rz, (p * ap).sum())
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = (r * z).sum()
        beta = _safe_ratio(rz_new, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _apply_update(problem: BAProblem, s, rhs, vinv, w_blk, g_p) -> BAProblem:
    """Solve the reduced system and back-substitute the point updates."""
    K = problem.poses.shape[0]
    if K <= DENSE_MAX_POSES:
        s_mat = s.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        with span("linalg", s.device):
            dc = torch.linalg.solve_ex(s_mat, rhs.reshape(-1, 1), check_errors=False).result.reshape(K, 6)
    else:
        dc = _solve_pose_system(s, rhs)
    dc_o = dc[problem.obs_cam]  # (P, Q, 6)
    wt_dc = torch.einsum("pqij,pqi->pj", w_blk, dc_o)
    dp = -torch.einsum("pij,pj->pi", vinv, g_p + wt_dc)
    return problem.replace(poses=problem.poses + dc, points=problem.points + dp)


def _lm_loop(problem: BAProblem, config: SfmConfig, reduce=None) -> BAProblem:
    total = (lambda x: x) if reduce is None else reduce
    lam = torch.full((), config.lm_lambda_init, dtype=torch.float32, device=problem.poses.device)
    cost = total(_cost(problem, config.huber_delta))
    for _ in range(config.ba_iterations):
        s, rhs, vinv, w_blk, g_p = _schur_system(problem, lam, config, reduce)
        cand = _apply_update(problem, s, rhs, vinv, w_blk, g_p)
        new_cost = total(_cost(cand, config.huber_delta))
        accept = new_cost < cost
        problem = problem.replace(poses=torch.where(accept, cand.poses, problem.poses),
                                  points=torch.where(accept, cand.points, problem.points))
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 3.0), 1e-9, config.lm_lambda_max)
    return problem


def bundle_adjust(problem: BAProblem, config: SfmConfig) -> BAProblem:
    """LM bundle adjustment (a fixed iteration count) on the device of the
    problem's tensors; float32 throughout."""
    out = _lm_loop(problem.replace(obs_cam=problem.obs_cam.long()), config)
    check_no_nan("bundle_adjust", out.poses, out.points)
    return out.replace(obs_cam=problem.obs_cam)


def bundle_adjust_sharded(problem: BAProblem, config: SfmConfig, mesh, axis: str = "data") -> BAProblem:
    """Distributed BA over the ranks of `mesh`'s `axis` (every rank calls it):
    `problem` is this rank's shard, its points and observation rows (a
    contiguous block of the whole problem's, e.g. from
    `interop.ba_problem_shards`) with the whole problem's poses and fixed
    flags.  Returns this rank's shard optimized; the poses come out the same
    on every rank.  With one rank it equals `bundle_adjust` bit for bit."""
    from akaze_tpu_torch.parallel.collectives import all_sum

    out = _lm_loop(problem.replace(obs_cam=problem.obs_cam.long()), config,
                   reduce=lambda x: all_sum(x, mesh, axis))
    check_no_nan("bundle_adjust_sharded", out.poses, out.points)
    return out.replace(obs_cam=problem.obs_cam)


def reprojection_rmse(problem: BAProblem) -> torch.Tensor:
    """Unweighted RMS reprojection error over valid observations."""
    r = project(*_observed(problem.replace(obs_cam=problem.obs_cam.long())), jacobians=False)
    n2 = (r * r).sum(-1).reshape(problem.obs_cam.shape) * problem.obs_valid
    denom = torch.clamp(problem.obs_valid.sum(), min=1)
    return torch.sqrt(n2.sum() / denom)
