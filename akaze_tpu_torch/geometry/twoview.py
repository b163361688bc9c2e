"""Two-view geometry of the port: RANSAC essential matrix, relative pose
and triangulation (counterpart of the JAX package's
`akaze_tpu/geometry/twoview.py`, same functions and choices).

A fixed number of 8-point hypotheses is solved as one batch (a det-minor
nullspace by Gaussian elimination, then a one-sided Jacobi projection onto
the essential manifold), every hypothesis is scored against every
correspondence by its Sampson distance, and the top `refit_beam`
hypotheses get three guarded least-squares refits (QR of the weighted
design matrix, then the SVD of its 9x9 R factor); the refit basin with the
most points in front of both cameras wins.  The reference's choices are
kept: inlier counts (not MSAC), refits accepted on ties, the QR -> SVD
refit (not normal equations), selection by cheirality count.

Every function takes float32 tensors on their device; where the JAX
package vmaps over pairs, `estimate_relative_pose_fn` takes a leading pair
axis.  Each top-k breaks ties by the lower index, as `lax.top_k` does
(`frontend/detect._topk_stable`), and `torch.argmax` takes the first
maximum, as `jnp.argmax` does.  Importing this module pins float32 matrix
products on the GPU (no TF32), whatever else was imported before.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from akaze_tpu_torch.core.config import RansacConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.frontend.detect import _topk_stable
from akaze_tpu_torch.utils.profiling import check_no_nan, span

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass
class TwoViewResult:
    """Essential matrix + relative pose (x2 ~ R @ x1 + t, |t| = 1); a
    leading pair axis where the inputs had one."""

    E: torch.Tensor  # f32 (..., 3, 3)
    R: torch.Tensor  # f32 (..., 3, 3)
    t: torch.Tensor  # f32 (..., 3)
    inliers: torch.Tensor  # bool (..., N)
    num_inliers: torch.Tensor  # i32 (...)


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


def _hypotheses(x1, x2, mask, sample_scores, config: RansacConfig):
    """The 8-point hypotheses of a batch of pairs: each is the top
    `sample_size` slots of one row of (P, H, N) scores with invalid slots
    scored -1 (ranked last, ties to the lower index), so a uniformly random
    subset of distinct valid slots.  Returns E (P, H, 3, 3), inliers
    (P, H, N) and counts (P, H) against every correspondence."""
    g = torch.where(mask[:, None, :], sample_scores, -1.0)
    _, idx = _topk_stable(g, config.sample_size)  # (P, H, 8)
    pairs = torch.arange(mask.shape[0], device=mask.device)[:, None, None]
    E = _essential_from_8pt(x1[pairs, idx], x2[pairs, idx])
    inl = _inliers(E, x1, x2, mask, config)
    return E, inl, inl.sum(-1, dtype=torch.int32)


def _inliers(E, x1, x2, mask, config: RansacConfig) -> torch.Tensor:
    """(P, B, N) Sampson inliers of (P, B, 3, 3) models on (P, N) pairs."""
    thr2 = float(np.float32(config.inlier_threshold**2))
    return (_sampson_sq(E, x1[:, None], x2[:, None]) < thr2) & mask[:, None, :]


def _refit(E, inl, cnt, x1, x2, mask, config: RansacConfig):
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
        with span("linalg", a.device):
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


def estimate_relative_pose_fn(x1, x2, mask, config: RansacConfig, generator=None,
                              sample_scores=None) -> TwoViewResult:
    """RANSAC essential matrix + cheirality-tested pose on tensors of one
    device: x1, x2 (N, 3) homogeneous normalized coordinates and mask (N,)
    valid correspondences, or a batch of pairs (P, N, 3) and (P, N).

    The hypotheses' random scores come from `sample_scores` ((H, N), or
    (P, H, N), with H = num_iterations) where the caller passes them, else
    from `generator` (a torch.Generator on the inputs' device), else from a
    new generator seeded with `config.seed`.  The JAX package draws
    `jax.random.uniform(key, (H, N))` instead; the two generators give
    different numbers, so the two packages agree only where JAX's draws are
    passed in as `sample_scores`.

    The top `refit_beam` hypotheses by inlier count (ties to the lower
    index) get the guarded refit, and the refit with the most inliers in
    front of both cameras wins (the first on ties): on plane-structured
    scenes a wrong E can keep most of the true model's Sampson inliers, but
    triangulates many of them behind a camera."""
    single = x1.ndim == 2
    if single:
        x1, x2, mask = x1[None], x2[None], mask[None]
        if sample_scores is not None:
            sample_scores = sample_scores[None]
    P, N = mask.shape
    dev = x1.device
    with span("geometry.twoview", dev):
        if sample_scores is None:
            if generator is None:
                generator = torch.Generator(device=dev)
                generator.manual_seed(config.seed)
            sample_scores = torch.rand((P, config.num_iterations, N), generator=generator, device=dev)
        with span("geometry.hypotheses", dev):
            E_h, inl_h, scores = _hypotheses(x1, x2, mask, sample_scores, config)
            M = min(config.refit_beam, config.num_iterations)
            _, top = _topk_stable(scores.to(torch.float32), M)  # (P, M)
        with span("geometry.refit", dev):
            E, inl, _ = _refit(_take(E_h, top), _take(inl_h, top), _take(scores, top), x1, x2, mask, config)
        with span("geometry.pose", dev):
            R_b, t_b, ch_b = _recover_pose(E, x1[:, None], x2[:, None], inl)
            best = torch.argmax(ch_b, dim=-1)[:, None]  # (P, 1)
            E, R, t, inl = (_take(x, best)[:, 0] for x in (E, R_b, t_b, inl))
    res = TwoViewResult(E=E, R=R, t=t, inliers=inl, num_inliers=inl.sum(-1, dtype=torch.int32))
    if single:
        res = TwoViewResult(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})
    return res


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
    with span("linalg", E.device):
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


def estimate_relative_pose(x1, x2, mask, config: RansacConfig | None = None, generator=None,
                           device="cuda", sample_scores=None) -> TwoViewResult:
    """RANSAC relative pose on `device` (the card unless the caller asks for
    the CPU): x1, x2 (N, 3) or (P, N, 3) normalized coordinates and mask
    (N,) or (P, N), as tensors or numpy arrays; see
    `estimate_relative_pose_fn` for the random draws."""
    config = config or RansacConfig()
    device = resolve_device(device)
    x1, x2, scores = (None if x is None else _on(x, device, torch.float32) for x in (x1, x2, sample_scores))
    res = estimate_relative_pose_fn(x1, x2, _on(mask, device, torch.bool), config, generator, scores)
    check_no_nan("estimate_relative_pose", res.E, res.R, res.t)
    return res


def _on(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A tensor or array-like as a `dtype` tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)
