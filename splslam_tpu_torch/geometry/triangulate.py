"""Two-view triangulation of points and line endpoints, batched DLT (port
of splslam_tpu/geometry/triangulate.py).

The reference's per-match cv::SVD DLT loops (src/LocalMapping.cc:484-984
CreateNewMapPoints / CreateNewMapLines, src/Initializer.cc:1127-1763)
become one batched 4x4 nullspace. The nullspace comes from
`ops/linalg.py::smallest_singular_vector` (Jacobi on A^T A in float64):
`torch.linalg.svd` waits for the host on a GPU, and inverse iteration
converges slowly where the two smallest singular values lie close.
"""

from __future__ import annotations

import torch

from splslam_tpu_torch.ops.linalg import smallest_singular_vector


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Batched linear triangulation. P1, P2: (3,4) projection matrices
    K[R|t]; uv1, uv2: (N,2) pixel observations. Returns (N,3) world points
    (the homogeneous DLT solution, its smallest singular vector)."""
    A = torch.stack([
        uv1[:, :1] * P1[2] - P1[0],
        uv1[:, 1:] * P1[2] - P1[1],
        uv2[:, :1] * P2[2] - P2[0],
        uv2[:, 1:] * P2[2] - P2[1],
    ], dim=1)                                     # [N,4,4]
    X = smallest_singular_vector(A)
    w = torch.where(torch.abs(X[:, 3]) < 1e-12, 1e-12, X[:, 3])
    return X[:, :3] / w[:, None]


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """K (3,3) and pose Tcw (4,4) -> P (3,4)."""
    return K @ Tcw[:3, :4]


def triangulation_checks(X: torch.Tensor, Tcw1: torch.Tensor, Tcw2: torch.Tensor,
                         uv1: torch.Tensor, uv2: torch.Tensor, K: torch.Tensor,
                         sigma2_1: torch.Tensor, sigma2_2: torch.Tensor,
                         chi2_th: float = 5.991,
                         min_parallax_cos: float = 0.9998) -> torch.Tensor:
    """Validity mask of triangulated points: finite, positive depth in both
    views, reprojection chi2 under the threshold in both views, enough
    parallax (the acceptance logic of the reference's CreateNewMapPoints,
    src/LocalMapping.cc:598-720)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def cam_and_reproj(Tcw, uv):
        pc = X @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
        u = fx * pc[:, 0] / z_safe + cx
        v = fy * pc[:, 1] / z_safe + cy
        return z, (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    z1, e1 = cam_and_reproj(Tcw1, uv1)
    z2, e2 = cam_and_reproj(Tcw2, uv2)
    finite = torch.all(torch.isfinite(X), dim=-1)
    # parallax between the two viewing rays
    C1 = -Tcw1[:3, :3].T @ Tcw1[:3, 3]
    C2 = -Tcw2[:3, :3].T @ Tcw2[:3, 3]
    r1, r2 = X - C1, X - C2
    cosp = torch.sum(r1 * r2, dim=-1) / (
        torch.linalg.vector_norm(r1, dim=-1) * torch.linalg.vector_norm(r2, dim=-1)
        + 1e-12)
    return (finite & (z1 > 0) & (z2 > 0) & (e1 < chi2_th * sigma2_1)
            & (e2 < chi2_th * sigma2_2) & (cosp < min_parallax_cos))


def triangulate_lines(P1: torch.Tensor, P2: torch.Tensor, seg1: torch.Tensor,
                      seg2: torch.Tensor) -> torch.Tensor:
    """Line segments as three 3D points (start, mid, end), each by DLT, as
    the reference's MapLine stores them (include/MapLine.h:121-123).
    seg1, seg2: (L,4) matched [sx, sy, ex, ey]. Returns (L,3,3)."""
    s1, e1 = seg1[:, :2], seg1[:, 2:]
    s2, e2 = seg2[:, :2], seg2[:, 2:]
    return torch.stack([
        triangulate_dlt(P1, P2, s1, s2),
        triangulate_dlt(P1, P2, 0.5 * (s1 + e1), 0.5 * (s2 + e2)),
        triangulate_dlt(P1, P2, e1, e2),
    ], dim=1)
