"""SO(3) utilities of the port: Rodrigues rotation vectors <-> matrices
(counterpart of the JAX package's `akaze_tpu/sfm/rotations.py`, same
formulas and branches).

Every function takes float32 tensors and broadcasts over leading axes.
No matrix product is used: the 3x3 algebra is written out elementwise, so
the result is float32 whatever matmul precision the caller has set.
`rotate_jacobian` is the closed-form derivative the BA and PnP Jacobians
use; the pose graph forward-differentiates through these functions with
`torch.func`, as the reference's `jacfwd` does.
"""

from __future__ import annotations

import torch


def _eye_like(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def rotvec_to_matrix(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 3, 3) matrix (Rodrigues), with
    series for sin(t)/t and (1 - cos(t))/t^2 near t = 0."""
    theta2 = (r * r).sum(-1, keepdim=True)[..., None]  # (..., 1, 1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    k = skew(r)
    eye = _eye_like(r)
    # K^2 = r r^T - |r|^2 I, elementwise (no matrix product).
    k2 = r[..., :, None] * r[..., None, :] - theta2 * eye
    return eye + a * k + b * k2


def matrix_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector, over the
    whole range [0, pi]: an atan2 angle (finite derivatives at theta = 0),
    and near pi the axis from the symmetric part (M + M^T + 2I) / 4 =
    axis axis^T, sign-aligned with the skew part."""
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    axis_raw = torch.stack(
        [m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], dim=-1
    )  # = 2 sin(theta) * axis
    s2 = (axis_raw * axis_raw).sum(-1, keepdim=True)
    sin_t = 0.5 * torch.sqrt(s2 + 1e-24)
    theta = torch.atan2(sin_t, cos_t[..., None])
    small = sin_t < 1e-4
    safe_sin = torch.where(small, 1.0, sin_t)
    factor = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * safe_sin))
    generic = axis_raw * factor

    # theta ~ pi: the largest-diagonal column of the symmetric part,
    # normalized, its sign aligned with axis_raw (the first maximum on ties,
    # as jnp.argmax takes it).
    b = 0.25 * (m + m.transpose(-1, -2)) + 0.5 * _eye_like(m)
    diag = torch.stack([b[..., 0, 0], b[..., 1, 1], b[..., 2, 2]], dim=-1)
    pick = (torch.argmax(diag, dim=-1)[..., None] == torch.arange(3, device=m.device)).to(m.dtype)
    col = (b * pick[..., None, :]).sum(-1)
    axis_pi = col / torch.sqrt(torch.clamp((col * col).sum(-1, keepdim=True), min=1e-24))
    flip = torch.where((axis_pi * axis_raw).sum(-1, keepdim=True) < 0.0, -1.0, 1.0)
    near_pi = (cos_t[..., None] < 0.0) & (sin_t < 5e-3)
    return torch.where(near_pi, axis_pi * flip * theta, generic)


def rotate(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply rotvec r (..., 3) to points x (..., 3)."""
    return (rotvec_to_matrix(r) * x[..., None, :]).sum(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]_x."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def rotate_jacobian(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d(R(r) x)/dr (..., 3, 3) of `rotvec_to_matrix`'s formula, branch by
    branch as forward-mode autodiff takes it.  With R x = x + a (r x x) +
    b (r (r.x) - theta^2 x), a = sin(t)/t, b = (1 - cos(t))/t^2:

        dRx/dr = -a [x]_x + (r x x) grad(a)^T
                 + b ((r.x) I + r x^T - 2 x r^T) + (r (r.x) - t^2 x) grad(b)^T,

    grad(a) = (cos(t) - a) / t^2 r and grad(b) = (a - 2 b) / t^2 r, or the
    series' -r/3 and -r/12 where theta^2 < 1e-8."""
    theta2 = (r * r).sum(-1, keepdim=True)  # (..., 1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-8
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2)
    ga = torch.where(small, -1.0 / 3.0, (cos_t - sin_t / theta) / theta2) * r
    gb = torch.where(small, -1.0 / 12.0, (sin_t / theta - 2.0 * (1.0 - cos_t) / theta2) / theta2) * r
    rdx = (r * x).sum(-1, keepdim=True)
    eye = _eye_like(r)
    outer = lambda u, v: u[..., :, None] * v[..., None, :]
    return (-a[..., None] * skew(x) + outer(torch.cross(r, x, dim=-1), ga)
            + b[..., None] * (rdx[..., None] * eye + outer(r, x) - 2.0 * outer(x, r))
            + outer(r * rdx - theta2 * x, gb))
