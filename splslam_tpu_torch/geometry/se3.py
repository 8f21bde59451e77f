"""SE(3) exponential map and retraction (port of splslam_tpu/geometry/se3.py).

Poses are 4x4 float32 matrices (world-to-camera `Tcw`); tangents are
`[rho(3), phi(3)]`. The small-angle series branches are the reference's
`where` selections, so both sides take the same branch on the same input.
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
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [rho, phi] (...,6) -> 4x4 transform (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian(phi) @ rho[..., :, None])[..., 0]
    return rt_to_mat(so3_exp(phi), t)


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ T (g2o VertexSE3Expmap)."""
    return se3_exp(xi) @ T
