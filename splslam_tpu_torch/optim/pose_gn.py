"""Pose-only Gauss-Newton on SE(3) (port of splslam_tpu/optim/pose_gn.py).

One camera pose against fixed landmarks: 2-dof reprojection rows
(chi2 5.991) and 3-dof stereo rows carrying the disparity residual
(chi2 7.815), analytic Jacobians for the left update exp(xi) * Tcw,
Huber-weighted normal equations in float32, a 6x6 Cholesky solve with
the reference's relative pivot floor, and `rounds` re-classification
rounds of `iters` steps (g2o PoseOptimization's 4x10 schedule).

Points only on this slice: the reference's line-midpoint rows are
structurally zero with capacity-1 line tables, so they are omitted, and
a line table of larger capacity raises. Keep TF32 off on a GPU: the
normal equations are float32 sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.geometry.camera import Camera

CHI2_POINT = 5.991   # 2-dof 95% (reference Optimizer.cc:476)
CHI2_STEREO = 7.815  # 3-dof 95% (reference Optimizer.cc:477 chi2Stereo)


class PointObs(NamedTuple):
    """Fixed-size point observation table for one frame. `ur` is the
    observed right-image x per keypoint (-1 = monocular row); None keeps
    the pure 2-dof program."""

    xyz_w: torch.Tensor       # [N,3] landmark world positions
    uv: torch.Tensor          # [N,2] observed pixels
    inv_sigma2: torch.Tensor  # [N] information scale (1/sigma^2 of octave)
    mask: torch.Tensor        # [N] bool — observation exists
    ur: torch.Tensor | None = None


class LineObs(NamedTuple):
    """Fixed-size line observation table (midpoint form) for one frame."""

    mid_w: torch.Tensor       # [L,3]
    coef: torch.Tensor        # [L,3]
    inv_sigma2: torch.Tensor  # [L]
    mask: torch.Tensor        # [L] bool

    @staticmethod
    def empty(n: int, device) -> "LineObs":
        return LineObs(
            torch.zeros((n, 3), device=device),
            torch.zeros((n, 3), device=device),
            torch.ones((n,), device=device),
            torch.zeros((n,), dtype=torch.bool, device=device),
        )


def _point_terms(Tcw, cam: Camera, pts: PointObs):
    """Residuals r [N,R], Jacobians J [N,R,6], valid depth mask, where
    R = 2 (pts.ur is None) or 3 (stereo rows; mono rows have row 3 zero)."""
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = pts.xyz_w @ R.T + t
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    z_ok = z > 1e-3
    zs = torch.where(z_ok, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    r2 = torch.stack([u - pts.uv[:, 0], v - pts.uv[:, 1]], dim=-1)
    zeros = torch.zeros_like(x)
    xiz, yiz = x * iz, y * iz
    Ju = torch.stack(
        [cam.fx * iz, zeros, -cam.fx * xiz * iz,
         -cam.fx * xiz * yiz, cam.fx * (1.0 + xiz * xiz),
         -cam.fx * yiz], dim=-1)
    Jv = torch.stack(
        [zeros, cam.fy * iz, -cam.fy * yiz * iz,
         -cam.fy * (1.0 + yiz * yiz), cam.fy * xiz * yiz,
         cam.fy * xiz], dim=-1)
    if pts.ur is None:
        return r2, torch.stack([Ju, Jv], dim=1), z_ok
    st = pts.ur >= 0
    r3 = torch.where(st, (u - cam.bf * iz) - pts.ur, 0.0)
    g0 = cam.fx * iz
    g2s = -cam.fx * xiz * iz + cam.bf * iz2
    Js = torch.stack(
        [g0, zeros, g2s, g2s * y, g0 * zs - g2s * x, -g0 * y], dim=-1)
    Js = Js * st[:, None].to(Js.dtype)
    r = torch.cat([r2, r3[:, None]], dim=-1)
    return r, torch.stack([Ju, Jv, Js], dim=1), z_ok


def solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 Cholesky solve with the reference's relative pivot floor
    (never raises on a near-singular H, unlike torch.linalg.cholesky).
    Each column is computed for all rows at once, with each element's
    subtractions in the reference's order."""
    n = 6
    L = torch.zeros_like(H)
    for j in range(n):
        col = H[j:, j]
        for k in range(j):
            col = col - L[j:, k] * L[j, k]
        Ljj = torch.sqrt(torch.maximum(col[0], 1e-10 * torch.abs(H[j, j])
                                       + 1e-20))
        L[j, j] = Ljj
        L[j + 1:, j] = col[1:] * (1.0 / Ljj)
    y = b.clone()
    for i in range(n):
        y[i] = y[i] / L[i, i]
        y[i + 1:] = y[i + 1:] - L[i + 1:, i] * y[i]
    x = y
    for i in reversed(range(n)):
        x[i] = x[i] / L[i, i]
        x[:i] = x[:i] - L[i, :i] * x[i]
    return x


def _huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber IRLS weight on the squared error (delta2 = delta^2)."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor          # (4,4)
    inlier_pt: torch.Tensor    # [N] bool
    n_inlier_pt: torch.Tensor  # scalar int32
    chi2_pt: torch.Tensor      # [N] final per-obs chi2
    unit_error: torch.Tensor   # scalar: total chi2 / #inliers


def pose_optimize(
    Tcw0: torch.Tensor,
    cam: Camera,
    pts: PointObs,
    lines: LineObs | None = None,
    *,
    rounds: int = 4,
    iters: int = 10,
    point_weight: float = 1.0,
    damping: float = 1e-5,
) -> PoseOptResult:
    """Optimize one camera pose against fixed landmarks (reference
    PoseOptimization, src/Optimizer.cc:409-520, with stereo edges)."""
    if lines is not None and lines.mask.shape[0] > 1:
        raise NotImplementedError("line pipeline: later slice")
    dev = Tcw0.device
    if pts.ur is None:
        gate_pt = CHI2_POINT
    else:
        gate_pt = torch.where(pts.ur >= 0, CHI2_STEREO, CHI2_POINT)
    eye6 = torch.eye(6, device=dev)

    def chi2s(Tcw, active):
        r, J, zok = _point_terms(Tcw, cam, pts)
        c = torch.sum(r * r, dim=-1) * pts.inv_sigma2
        return r, J, c, active & zok

    Tcw = Tcw0
    active = pts.mask
    for _ in range(rounds):
        for _ in range(iters):
            r, J, c, m = chi2s(Tcw, active)
            w = _huber_weight(c, gate_pt) * pts.inv_sigma2 * m * point_weight
            Jw = J * w[:, None, None]
            H = torch.einsum("nik,nil->kl", Jw, J)
            g = torch.einsum("nik,ni->k", Jw, r)
            H = H + damping * eye6 * (1.0 + torch.trace(H) / 6.0)
            dx = -solve6(H, g)
            ok = torch.all(torch.isfinite(dx)) & (torch.sum(w) > 0)
            dx = torch.where(ok, dx, 0.0)
            Tcw = se3.se3_retract(Tcw, dx)
        _, _, c, m = chi2s(Tcw, active)
        active = pts.mask & (c <= gate_pt) & m
    _, _, c, _ = chi2s(Tcw, active)
    n_pt = torch.sum(active.to(torch.int32))
    total = torch.sum(torch.where(active, c, 0.0))
    unit = total / torch.clamp(n_pt, min=1)
    return PoseOptResult(Tcw, active, n_pt, c, unit)
