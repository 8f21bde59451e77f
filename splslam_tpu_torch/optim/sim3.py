"""Sim(3) estimation (port of splslam_tpu/optim/sim3.py, verification
side): the reference's Sim3Solver (src/Sim3Solver.cc, Horn closed form
from 3-point samples + RANSAC with two-image reprojection checks) and
Optimizer::OptimizeSim3 (src/Optimizer.cc:1216, symmetric projection
edges), as batched tensor passes.

- `sim3_horn`: closed-form similarity from >= 3 point pairs, batched
  over leading dimensions.
- `sim3_ransac`: every hypothesis of a [H,3] sample table scored in one
  pass. The samples are an argument: the caller draws them
  (`slam/reloc.py::sample_minimal_sets`), so a test can inject another
  implementation's draws.
- `optimize_sim3`: Gauss-Newton on the 7-dof tangent [rho, phi, sigma]
  with Jacobians from `torch.func.jacfwd` of the residuals.

A Sim3 is the triple (s, R, t); `fix_scale=True` keeps s = 1. All float32
(Horn's rotation in float64, `ops/linalg.py`); keep TF32 off on a GPU. No
step reads a value back to the host.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from splslam_tpu_torch.geometry import se3
from splslam_tpu_torch.ops.linalg import rotation_and_singular_values

CHI2_RANSAC = 9.21   # 2-dof 99% (reference Sim3Solver, 9.210 * sigma2)
CHI2_OPT = 10.0      # reference OptimizeSim3 th2


def sim3_horn(X1: torch.Tensor, X2: torch.Tensor, w: torch.Tensor | None = None,
              fix_scale: bool = False):
    """Closed-form S12 = (s, R, t) with X1 ~ s R X2 + t from point sets
    [..., N, 3] and optional weights [..., N] (Horn 1987, reference
    Sim3Solver::ComputeSim3)."""
    if w is None:
        w = torch.ones(X1.shape[:-1], device=X1.device)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    c1 = torch.sum(X1 * w[..., None], dim=-2) / wsum[..., None]
    c2 = torch.sum(X2 * w[..., None], dim=-2) / wsum[..., None]
    Y1 = X1 - c1[..., None, :]
    Y2 = X2 - c2[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", Y1, Y2, w)
    # U diag(1, 1, det(U) det(V)) V^T of H = U S V^T, without torch's SVD
    R, _ = rotation_and_singular_values(H)
    if fix_scale:
        s = torch.ones(H.shape[:-2], device=H.device)
    else:
        num = torch.sum(Y1 * (Y2 @ R.transpose(-1, -2)) * w[..., None],
                        dim=(-2, -1))
        den = torch.clamp(torch.sum(Y2 * Y2 * w[..., None], dim=(-2, -1)),
                          min=1e-12)
        s = num / den
    t = c1 - s[..., None] * (R @ c2[..., :, None])[..., 0]
    return s, R, t


def _project(fx, fy, cx, cy, pc: torch.Tensor) -> torch.Tensor:
    zs = torch.where(pc[..., 2] > 1e-6, pc[..., 2], 1e-6)
    return torch.stack([fx * pc[..., 0] / zs + cx, fy * pc[..., 1] / zs + cy],
                       dim=-1)


def _intrinsics(K: torch.Tensor):
    return K[0, 0], K[1, 1], K[0, 2], K[1, 2]


def sim3_ransac(
    X1: torch.Tensor,     # [N,3] matched map points in KF1 camera frame
    X2: torch.Tensor,     # [N,3] same landmarks in KF2 camera frame
    uv1: torch.Tensor,    # [N,2] observations in image 1
    uv2: torch.Tensor,    # [N,2] observations in image 2
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    mask: torch.Tensor,   # [N] bool
    K: torch.Tensor,      # (3,3)
    samples: torch.Tensor,  # [H,3] minimal sets
    fix_scale: bool = False,
):
    """Batched Sim3 RANSAC (reference Sim3Solver::iterate): the first
    hypothesis with the most inliers, refit on its inliers and kept if
    the refit has as many. Returns ((s,R,t) S12, n_inliers, inlier mask)."""
    fx, fy, cx, cy = _intrinsics(K)

    def inliers_of(s, R, t):       # batched over leading dims of s
        p1 = se3.sim3_apply(s, R, t, X2)                 # S12 X2 -> frame 1
        e1 = torch.sum((_project(fx, fy, cx, cy, p1) - uv1) ** 2, dim=-1)
        p2 = se3.sim3_apply(*se3.sim3_inverse(s, R, t), X1)  # S21 X1 -> 2
        e2 = torch.sum((_project(fx, fy, cx, cy, p2) - uv2) ** 2, dim=-1)
        return (mask & (e1 * inv_sigma2_1 < CHI2_RANSAC)
                & (e2 * inv_sigma2_2 < CHI2_RANSAC))

    idx = samples.long()
    ss, Rs, ts = sim3_horn(X1[idx], X2[idx], fix_scale=fix_scale)
    counts = torch.sum(inliers_of(ss, Rs, ts).to(torch.int32), dim=-1)
    best = torch.argmax(counts)[None]      # a 1-d index gathers on the device
    s, R, t = ss[best][0], Rs[best][0], ts[best][0]
    inl = inliers_of(s, R, t)
    s2, R2, t2 = sim3_horn(X1, X2, inl.float(), fix_scale=fix_scale)
    inl2 = inliers_of(s2, R2, t2)
    better = torch.sum(inl2.to(torch.int32)) >= torch.sum(inl.to(torch.int32))
    s = torch.where(better, s2, s)
    R = torch.where(better, R2, R)
    t = torch.where(better, t2, t)
    inl = inliers_of(s, R, t)
    return (s, R, t), torch.sum(inl.to(torch.int32)), inl


def _retract(xi, s, R, t):
    """Left update exp(xi) * (s, R, t)."""
    ds, dR, dt = se3.sim3_exp(xi)
    return s * ds, dR @ R, ds * (dR @ t) + dt


def sim3_residuals(xi, s, R, t, X1, X2, uv1, uv2, sq1, sq2, K):
    """Symmetric projection residuals [2N,2] of exp(xi) * S12, weighted by
    sq = sqrt(inv_sigma2) [N,1]: S12 X2 into image 1, then S21 X1 into
    image 2."""
    fx, fy, cx, cy = _intrinsics(K)
    s_n, R_n, t_n = _retract(xi, s, R, t)
    p1 = se3.sim3_apply(s_n, R_n, t_n, X2)
    r1 = (_project(fx, fy, cx, cy, p1) - uv1) * sq1
    p2 = se3.sim3_apply(*se3.sim3_inverse(s_n, R_n, t_n), X1)
    r2 = (_project(fx, fy, cx, cy, p2) - uv2) * sq2
    return torch.cat([r1, r2], dim=0)


def optimize_sim3(
    s0, R0, t0,
    X1: torch.Tensor, X2: torch.Tensor,
    uv1: torch.Tensor, uv2: torch.Tensor,
    inv_sigma2_1: torch.Tensor, inv_sigma2_2: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
    iters: int = 10,
    fix_scale: bool = False,
):
    """GN refinement of S12 with symmetric projection residuals, Huber
    weights at chi2 10 (reference Optimizer::OptimizeSim3). Returns
    ((s,R,t), n_inliers, inlier mask, n_guarded): n_guarded counts steps
    zeroed because the solve was not finite."""
    N = X1.shape[0]
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals(xi, s, R, t):                          # [2N,2]
        return sim3_residuals(xi, s, R, t, X1, X2, uv1, uv2, sq1, sq2, K)

    zero = torch.zeros(7, device=X1.device)

    def chi2_of(s, R, t):
        r = residuals(zero, s, R, t)
        return torch.sum(r[:N] ** 2, dim=-1), torch.sum(r[N:] ** 2, dim=-1)

    c1, c2 = chi2_of(s0, R0, t0)
    active = mask & (c1 < CHI2_RANSAC) & (c2 < CHI2_RANSAC)
    w_act = torch.cat([active, active]).float()
    s, R, t = s0, R0, t0
    n_guarded = torch.zeros((), dtype=torch.int32, device=X1.device)
    eye7 = torch.eye(7, device=X1.device)
    keep = (torch.arange(7, device=X1.device) < 6).float()
    for _ in range(iters):
        r0 = residuals(zero, s, R, t)
        J = jacfwd(lambda xi: residuals(xi, s, R, t))(zero)   # [2N,2,7]
        c = torch.sum(r0 * r0, dim=-1)
        w = w_act * torch.where(c <= CHI2_OPT, 1.0,
                                torch.sqrt(CHI2_OPT / torch.clamp(c, min=1e-9)))
        H = torch.einsum("nik,n,nil->kl", J, w, J)
        b = torch.einsum("nik,n,ni->k", J, w, r0)
        if fix_scale:
            # sigma (the last tangent coordinate) held: its row and column
            # of H zeroed with a unit diagonal, its gradient zeroed
            H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
            b = b * keep
        H = H + 1e-6 * eye7 * torch.clamp(torch.trace(H) / 7.0, min=1.0)
        dx = -torch.linalg.solve_ex(H, b)[0]
        ok = torch.all(torch.isfinite(dx))
        n_guarded = n_guarded + (~ok).to(torch.int32)
        dx = torch.where(ok, dx, 0.0)
        s, R, t = _retract(dx, s, R, t)
    c1, c2 = chi2_of(s, R, t)
    inl = mask & (c1 < CHI2_OPT) & (c2 < CHI2_OPT)
    return (s, R, t), torch.sum(inl.to(torch.int32)), inl, n_guarded
