"""The plain reference of two-view relative pose: the fixed-iteration
8-point RANSAC on the essential matrix (det-minor nullspace, Jacobi
projection onto the essential manifold, Sampson inliers), the guarded QR ->
SVD refit of the top hypotheses, and the cheirality-tested decomposition,
in float32 PyTorch ops (`torch.linalg` for the QR and the SVDs).

Hypotheses come from caller-given random scores (P, H, N): the benchmark
draws them from the seed and hands the same draws to the program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark.reference.akaze import topk_stable


@dataclasses.dataclass
class RansacParams:
    """The RANSAC's options, as a traffic mix names them."""

    num_iterations: int = 512
    sample_size: int = 8
    inlier_threshold: float = 1e-3
    refit_beam: int = 32


@dataclasses.dataclass
class TwoViewResult:
    E: torch.Tensor  # f32 (P, 3, 3)
    R: torch.Tensor  # f32 (P, 3, 3)
    t: torch.Tensor  # f32 (P, 3)
    inliers: torch.Tensor  # bool (P, N)
    num_inliers: torch.Tensor  # i32 (P,)


def normalize_points(x: torch.Tensor, y: torch.Tensor, intrinsics) -> torch.Tensor:
    """Pixel -> normalized camera coords; intrinsics = (fx, fy, cx, cy).
    Returns homogeneous (..., N, 3)."""
    fx, fy, cx, cy = intrinsics
    xn = (x - cx) / fx
    yn = (y - cy) / fy
    return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)


def _det8(m: torch.Tensor) -> torch.Tensor:
    """Batched determinant of (..., 8, 8) by Gaussian elimination with
    partial pivoting (the first largest |entry| of the column is the
    pivot, as the reference's argmax picks it)."""
    n = m.shape[-1]
    det = torch.ones(m.shape[:-2], dtype=m.dtype, device=m.device)
    rows = torch.arange(n, device=m.device)
    for k in range(n):
        col = torch.where(rows >= k, m[..., :, k].abs(), -1.0)  # rows above k are settled
        p = torch.argmax(col, dim=-1)  # (...,) pivot row
        row_k = m[..., k, :]
        row_p = torch.gather(m, -2, p[..., None, None].expand(*p.shape, 1, n))[..., 0, :]
        is_k = (rows == k)[:, None]
        is_p = (rows == p[..., None])[..., None]
        m = torch.where(is_k, row_p[..., None, :], m)
        m = torch.where(is_p & ~is_k, row_k[..., None, :], m)
        det = torch.where(p == k, det, -det)
        pivot = m[..., k, k]
        det = det * pivot
        # Eliminate below the pivot (masked rank-1 update of the whole matrix).
        safe = torch.where(pivot == 0, 1.0, pivot)
        f = torch.where(rows > k, m[..., :, k] / safe[..., None], 0.0)
        m = m - f[..., :, None] * m[..., k : k + 1, :]
    return det


@functools.lru_cache(maxsize=8)
def _minor_columns(device: torch.device) -> tuple:
    """The column indices of the 9 (8, 8) minors of an (8, 9) matrix and
    their cofactor signs, on `device`."""
    cols = torch.tensor([[c for c in range(9) if c != i] for i in range(9)], device=device)
    signs = torch.tensor([(-1.0) ** i for i in range(9)], device=device)
    return cols, signs


def _nullspace_9(a: torch.Tensor) -> torch.Tensor:
    """Right null vector of a batched (..., 8, 9) system by the generalized
    cross product x_i = (-1)^i det(a without column i); the nine minors go
    through one batched (..., 9, 8, 8) elimination.  Rank-deficient inputs
    give ~0 vectors (their hypotheses score no inliers)."""
    cols, signs = _minor_columns(a.device)
    minors = a[..., :, cols].movedim(-2, -3)  # (..., 9, 8, 8)
    x = signs * _det8(minors)
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)), min=1e-30)


def _enforce_essential(e: torch.Tensor, sweeps: int = 4) -> torch.Tensor:
    """Project batched (..., 3, 3) matrices onto the essential manifold
    (singular values -> (1, 1, 0)) by a one-sided Jacobi SVD: cyclic
    rotations orthogonalize the columns (A G1 G2 ... = U diag(s)), the same
    rotations applied to the identity accumulate V, and the projection is
    the sum of u_i v_i^T over the two largest singular values (ties to the
    lower index)."""
    a = [e[..., :, j] for j in range(3)]  # columns, (..., 3) each
    eye = torch.eye(3, dtype=e.dtype, device=e.device).expand(e.shape)
    v = [eye[..., :, j] for j in range(3)]
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ap, aq = a[p], a[q]
            app = (ap * ap).sum(-1)
            aqq = (aq * aq).sum(-1)
            apq = (ap * aq).sum(-1)
            tau = (aqq - app) / (2.0 * torch.where(apq == 0, 1.0, apq))
            # tau == 0 with apq != 0 means app == aqq exactly: sign(0) = 0
            # would skip the rotation, the right Jacobi angle is 45 degrees.
            t = torch.where(tau == 0, 1.0, torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau)))
            t = torch.where(apq == 0, 0.0, t)
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = c * t[..., None]
            a[p], a[q] = c * ap - s * aq, s * ap + c * aq
            vp, vq = v[p], v[q]
            v[p], v[q] = c * vp - s * vq, s * vp + c * vq
    norms = torch.stack([torch.sqrt((col * col).sum(-1)) for col in a], dim=-1)  # singular values
    n_i, n_j = norms[..., :, None], norms[..., None, :]
    idx = torch.arange(3, device=e.device)
    rank = ((n_j > n_i) | ((n_j == n_i) & (idx[None, :] < idx[:, None]))).sum(-1)
    keep = (rank <= 1).to(e.dtype)  # (..., 3)
    u = torch.stack(a, dim=-1) / torch.clamp(norms[..., None, :], min=1e-30)
    uk = u * keep[..., None, :]
    vm = torch.stack(v, dim=-1)
    return (uk[..., :, None, :] * vm[..., None, :, :]).sum(-1)


def _essential_from_8pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point solve: x1, x2 (..., 8, 3) -> E (..., 3, 3) with the
    essential constraint enforced."""
    a = (x2[..., :, :, None] * x1[..., :, None, :]).reshape(*x1.shape[:-2], 8, 9)
    e = _nullspace_9(a).reshape(*x1.shape[:-2], 3, 3)
    return _enforce_essential(e)


def _sampson_sq(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance: E (..., 3, 3), x1/x2 (..., N, 3) whose
    leading axes broadcast against E's -> (..., N)."""
    ex1 = torch.matmul(x1, E.transpose(-1, -2))  # (E x1)_n
    etx2 = torch.matmul(x2, E)  # (E^T x2)_n
    err = (x2 * ex1).sum(-1)
    denom = ex1[..., 0] ** 2 + ex1[..., 1] ** 2 + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    return err * err / torch.clamp(denom, min=1e-12)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, H, ...) at idx (P, M) along axis 1 -> (P, M, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _hypotheses(x1, x2, mask, sample_scores, config: RansacParams):
    """The 8-point hypotheses of a batch of pairs: each is the top
    `sample_size` slots of one row of (P, H, N) scores with invalid slots
    scored -1 (ranked last, ties to the lower index), so a uniformly random
    subset of distinct valid slots.  Returns E (P, H, 3, 3), inliers
    (P, H, N) and counts (P, H) against every correspondence."""
    g = torch.where(mask[:, None, :], sample_scores, -1.0)
    _, idx = topk_stable(g, config.sample_size)  # (P, H, 8)
    pairs = torch.arange(mask.shape[0], device=mask.device)[:, None, None]
    E = _essential_from_8pt(x1[pairs, idx], x2[pairs, idx])
    inl = _inliers(E, x1, x2, mask, config)
    return E, inl, inl.sum(-1, dtype=torch.int32)


def _inliers(E, x1, x2, mask, config: RansacParams) -> torch.Tensor:
    """(P, B, N) Sampson inliers of (P, B, 3, 3) models on (P, N) pairs."""
    thr2 = float(np.float32(config.inlier_threshold**2))
    return (_sampson_sq(E, x1[:, None], x2[:, None]) < thr2) & mask[:, None, :]


def _refit(E, inl, cnt, x1, x2, mask, config: RansacParams):
    """Three rounds of guarded least-squares refit of a (P, M) beam of
    models: the smallest right singular vector of the inlier-weighted design
    matrix by QR, then the SVD of its 9x9 R factor (R shares the matrix's right
    singular vectors, without squaring its condition as normal equations
    would), projected onto the essential manifold.  A round is kept when it
    does not lose inliers: ties are accepted, since with every match an
    inlier the refit over all of them still beats any 8-point solve, and a
    refit that loses inliers (a drift onto a spurious nullspace direction)
    is rejected.

    A problem with a non-finite correspondence (any row of the design
    matrix, masked or not) keeps its beam as it is: the reference's
    weighted matrix carries NaN x 0 = NaN there, its refit scores no
    inliers, and every round is rejected.  The non-finite entries are
    zeroed before the QR, which leaves every finite input bit for bit as
    it was, so the CPU's SVD does not raise on a NaN factor.  Returns the
    refit (E, inliers, counts)."""
    P, M = cnt.shape
    a = (x2[..., :, None] * x1[..., None, :]).reshape(*x1.shape[:-1], 9)  # (P, N, 9)
    finite = torch.isfinite(a)
    poisoned = ~finite.all(dim=-1).all(dim=-1)  # (P,)
    a = torch.where(finite, a, 0.0)
    for _ in range(3):
        w = inl.to(torch.float32)
        r = torch.linalg.qr(a[:, None] * w[..., None], mode="r").R  # (P, M, 9, 9)
        e = torch.linalg.svd(r).Vh[..., -1, :].reshape(P, M, 3, 3)
        u, _, vt = torch.linalg.svd(e)
        E_new = u[..., :, :2] @ vt[..., :2, :]  # u diag(1, 1, 0) vt
        inl_new = _inliers(E_new, x1, x2, mask, config)
        cnt_new = inl_new.sum(-1, dtype=torch.int32)
        better = (cnt_new >= cnt) & ~poisoned[:, None]
        E = torch.where(better[..., None, None], E_new, E)
        inl = torch.where(better[..., None], inl_new, inl)
        cnt = torch.where(better, cnt_new, cnt)
    return E, inl, cnt


def relative_pose(x1, x2, mask, sample_scores, config: RansacParams) -> TwoViewResult:
    """RANSAC essential matrix + cheirality-tested pose of a batch of pairs:
    x1, x2 (P, N, 3) homogeneous normalized coordinates, mask (P, N) valid
    correspondences, sample_scores (P, H, N) with H = num_iterations.  The
    top `refit_beam` hypotheses by inlier count (ties to the lower index)
    get the guarded refit, and the refit with the most inliers in front of
    both cameras wins (the first on ties)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    E_h, inl_h, scores = _hypotheses(x1, x2, mask, sample_scores, config)
    M = min(config.refit_beam, config.num_iterations)
    _, top = topk_stable(scores.to(torch.float32), M)  # (P, M)
    E, inl, _ = _refit(_take(E_h, top), _take(inl_h, top), _take(scores, top), x1, x2, mask, config)
    R_b, t_b, ch_b = _recover_pose(E, x1[:, None], x2[:, None], inl)
    best = torch.argmax(ch_b, dim=-1)[:, None]  # (P, 1)
    E, R, t, inl = (_take(x, best)[:, 0] for x in (E, R_b, t_b, inl))
    return TwoViewResult(E=E, R=R, t=t, inliers=inl, num_inliers=inl.sum(-1, dtype=torch.int32))


@functools.lru_cache(maxsize=8)
def _w_matrix(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def _recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, inliers: torch.Tensor):
    """Decompose E (..., 3, 3) into its 4 (R, t) candidates and keep the one
    with the most inliers in front of both cameras (the first on ties).
    x1, x2 (..., N, 3) and inliers (..., N) broadcast against E's leading
    axes.  Returns (R, t, cheirality count).

    A non-finite E (an 8-point sample that held a non-finite
    correspondence) gives a NaN pose with count 0, as the reference's SVD
    does; it is decomposed as a zero matrix, since the CPU's SVD raises on
    NaN."""
    finite = torch.isfinite(E).all(-1).all(-1)
    u, _, vt = torch.linalg.svd(torch.where(finite[..., None, None], E, 0.0))
    # Proper rotations: flip the sign of a factor whose determinant is < 0.
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    w = _w_matrix(E.device, E.dtype)
    r1 = u @ w @ vt
    r2 = u @ w.T @ vt
    t = u[..., :, 2]
    Rs = torch.stack([r1, r1, r2, r2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)

    pts = triangulate(Rs, ts, x1[..., None, :, :], x2[..., None, :, :])  # (..., 4, N, 3)
    z1 = pts[..., 2]
    z2 = (Rs[..., 2, None, :] * pts).sum(-1) + ts[..., 2, None]
    good = (z1 > 0) & (z2 > 0) & inliers[..., None, :]
    counts = torch.where(finite[..., None], good.sum(-1, dtype=torch.int32), 0)  # (..., 4)
    best = torch.argmax(counts, dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0, :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    R = torch.where(finite[..., None, None], R, torch.nan)
    t = torch.where(finite[..., None], t, torch.nan)
    return R, t, torch.take_along_dim(counts, best[..., None], dim=-1)[..., 0]


def triangulate(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Midpoint triangulation; R (..., 3, 3), t (..., 3), x1/x2 (..., N, 3)
    normalized homogeneous (leading axes broadcast against R's) -> (..., N,
    3) points in the camera-1 frame.

    Solves the 2-unknown least-squares depth system
        d1 * x1 - d2 * R^T x2 = -R^T t
    with a closed-form 2x2 normal-equation inverse."""
    rx2 = torch.matmul(x2, R)  # R^T x2, (..., N, 3)
    b = -torch.matmul(t[..., None, :], R)  # -R^T t, (..., 1, 3)
    a11 = (x1 * x1).sum(-1)
    a12 = -(x1 * rx2).sum(-1)
    a22 = (rx2 * rx2).sum(-1)
    b1 = (x1 * b).sum(-1)
    b2 = -(rx2 * b).sum(-1)
    det = a11 * a22 - a12 * a12
    safe_det = torch.where(det.abs() < 1e-12, 1e-12, det)
    d1 = (b1 * a22 - b2 * a12) / safe_det
    d2 = (b2 * a11 - b1 * a12) / safe_det
    p1 = d1[..., None] * x1
    p2 = d2[..., None] * rx2 + b
    return 0.5 * (p1 + p2)


def correspondences(xa, ya, xb, yb, idx_b, accepted, intrinsics):
    """The normalized correspondences of matched pairs: each row of A with
    the row of B it matched, masked by the match's acceptance."""
    idx = idx_b.long()
    x1 = normalize_points(xa, ya, intrinsics)
    x2 = normalize_points(torch.gather(xb, 1, idx), torch.gather(yb, 1, idx), intrinsics)
    return x1, x2, accepted
