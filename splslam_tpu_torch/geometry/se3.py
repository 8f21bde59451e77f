"""SE(3) exponential and logarithm maps, inverse, point transform and
retraction, and the Sim(3) group (port of splslam_tpu/geometry/se3.py).

Poses are 4x4 float32 matrices (world-to-camera `Tcw`); tangents are
`[rho(3), phi(3)]`, and `[rho, phi, sigma]` for Sim(3). The small-angle
series branches are the reference's `where` selections, so both sides
take the same branch on the same input.
All products run in float32; callers keep TF32 off on a GPU.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector. Batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with the reference's series fallback near 0."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    K = hat(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi), used inside SE(3) exp."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    big = theta2 > _EPS
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    c = torch.where(big, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    K = hat(phi)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> homogeneous (...,4,4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: writing a Python number into a CUDA
    # tensor copies it from the host and stalls the stream
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [rho, phi] (...,6) -> 4x4 transform (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian(phi) @ rho[..., :, None])[..., 0]
    return rt_to_mat(so3_exp(phi), t)


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ T (g2o VertexSE3Expmap)."""
    return se3_exp(xi) @ T


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle. Batched. Within 1e-3 rad of pi the
    axis comes from the diagonal of R, signed by the off-diagonal
    differences, as in the reference."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    # theta / (2 sin theta), series near 0
    scale = torch.where(torch.abs(sin_t) > _EPS,
                        theta / (2.0 * sin_t + _EPS * torch.sign(sin_t + _EPS)),
                        0.5 + theta * theta / 12.0)
    small = w * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    signs = torch.where(w < 0, -1.0, 1.0)
    big = axis * signs * theta[..., None]
    return torch.where((theta > (torch.pi - 1e-3))[..., None], big, small)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform (...,4,4) -> tangent [rho, phi] (...,6)."""
    phi = so3_log(T[..., :3, :3])
    rho = torch.linalg.solve_ex(_left_jacobian(phi), T[..., :3, 3:4])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (...,4,4): (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3) or (N,3)."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


# ---------------------------------------------------------------------------
# Sim(3), carried as (s, R, t): scale, rotation, translation.
# ---------------------------------------------------------------------------


def sim3_exp(xi: torch.Tensor):
    """Tangent [rho(3), phi(3), sigma(1)] -> (s, R, t), t = W @ rho.

    The four small-angle / small-scale limits are `where` selections whose
    unselected branches divide by a safe denominator (1.0), so the map and
    its forward-mode derivative stay finite at xi = 0, where every limit
    branch is taken (Strasdat's Sim(3) exponential, as the reference)."""
    if xi.dim() == 1:
        # Forward-mode AD promotes the tangent of a 0-dim tensor combined
        # with a Python float to float64; keep the scalars 1-D.
        return tuple(v[0] for v in sim3_exp(xi[None]))
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)

    sig_small = torch.abs(sigma) < 1e-5
    th_small = theta < 1e-5
    sig_safe = torch.where(sig_small, 1.0, sigma)
    th2_safe = torch.where(th_small, 1.0, theta2)
    th_safe = torch.where(th_small, 1.0, theta)
    c2 = sigma * sigma + theta2
    c2_safe = torch.where(c2 < _EPS, 1.0, c2)

    C = torch.where(sig_small, 1.0, (s - 1.0) / sig_safe)
    a_ss = s * torch.sin(theta)
    b_sc = s * torch.cos(theta)
    # A multiplies K
    A_gen = (a_ss * sigma + (1.0 - b_sc) * theta) / (th_safe * c2_safe)
    A_sig0 = (1.0 - torch.cos(theta)) / th2_safe
    A_th0 = torch.where(sig_small, 0.5,
                        ((sigma - 1.0) * s + 1.0) / (sig_safe * sig_safe))
    A = torch.where(th_small, A_th0, torch.where(sig_small, A_sig0, A_gen))
    # B multiplies K @ K
    B_gen = (C - ((b_sc - 1.0) * sigma + a_ss * theta) / c2_safe) / th2_safe
    B_sig0 = (theta - torch.sin(theta)) / (th2_safe * th_safe)
    B_th0 = torch.where(
        sig_small, 1.0 / 6.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0)
        / (sig_safe * sig_safe * sig_safe))
    B = torch.where(th_small, B_th0, torch.where(sig_small, B_sig0, B_gen))

    W = (C[..., None, None] * _eye_like(K) + A[..., None, None] * K
         + B[..., None, None] * (K @ K))
    t = (W @ rho[..., :, None])[..., 0]
    return s, R, t


def sim3_apply(s, R, t, pts: torch.Tensor) -> torch.Tensor:
    """s R p + t for points (..., N, 3)."""
    return s[..., None, None] * (pts @ R.transpose(-1, -2)) + t[..., None, :]


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = torch.reciprocal(s)   # no Python float: see sim3_exp
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., :, None])[..., 0]


def sim3_compose(a, b):
    """Compose Sim3 a o b (apply b first)."""
    sa, Ra, ta = a
    sb, Rb, tb = b
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., :, None])[..., 0] + ta
