"""Sim(3) estimation and pose-graph optimization (port of
splslam_tpu/optim/sim3.py): the reference's Sim3Solver
(src/Sim3Solver.cc, Horn closed form from 3-point samples + RANSAC with
two-image reprojection checks), Optimizer::OptimizeSim3
(src/Optimizer.cc:1216, symmetric projection edges) and
Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:951, the Sim3 pose
graph over spanning-tree, covisibility and loop edges), as batched
tensor passes.

- `sim3_horn`: closed-form similarity from >= 3 point pairs, batched
  over leading dimensions.
- `sim3_ransac`: every hypothesis of a [H,3] sample table scored in one
  pass. The samples are an argument: the caller draws them
  (`slam/reloc.py::sample_minimal_sets`), so a test can inject another
  implementation's draws.
- `optimize_sim3`: Gauss-Newton on the 7-dof tangent [rho, phi, sigma]
  with Jacobians from `torch.func.jacfwd` of the residuals.
- `pose_graph_sim3`: Gauss-Newton over every keyframe's Sim3 with dense
  normal equations (7K x 7K) and one LU solve an iteration.

A Sim3 is the triple (s, R, t); `fix_scale=True` keeps s = 1. All float32
(Horn's rotation in float64, `ops/linalg.py`); keep TF32 off on a GPU. No
step reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

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
    """Left update exp(xi) * (s, R, t), batched over leading dims."""
    ds, dR, dt = se3.sim3_exp(xi)
    return s * ds, dR @ R, ds[..., None] * (dR @ t[..., :, None])[..., 0] + dt


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


class PoseGraphEdges(NamedTuple):
    """Sim3 constraints between keyframe slots (spanning trees,
    covisibility and loop edges, reference Optimizer.cc:1019-1189)."""

    i: torch.Tensor        # [E] int32
    j: torch.Tensor        # [E] int32
    s: torch.Tensor        # [E] measured S_ij scale
    R: torch.Tensor        # [E,3,3]
    t: torch.Tensor        # [E,3]
    weight: torch.Tensor   # [E] f32 (0 masks the edge)


def pose_graph_sim3(
    s_all: torch.Tensor,    # [K] initial scales (1 for non-corrected)
    R_all: torch.Tensor,    # [K,3,3] Tcw rotations
    t_all: torch.Tensor,    # [K,3]
    free: torch.Tensor,     # [K] bool (False = gauge anchor, e.g. keyframe 0)
    edges: PoseGraphEdges,
    iters: int = 12,
    fix_scale: bool = False,
):
    """Batched GN on the Sim3 pose graph: the residual of edge (i, j) is
    the tangent-space error of S_meas * (S_i S_j^-1)^-1 (zero iff the
    relative pose matches the measurement): translation, the skew part of
    the rotation (smooth at the identity, where a log's arccos is not) and
    log s. Returns (s, R, t, n_guarded) per keyframe; n_guarded counts the
    iterations whose update was zeroed because the solve was not finite
    (0 on a healthy solve).

    The blocks of edges that share a keyframe are summed by `index_add_`,
    on CUDA in launch order: float noise between runs, and no decision
    hangs on it (there is no accept test)."""
    K = s_all.shape[0]
    dev = s_all.device
    E = edges.i.shape[0]
    ei, ej = edges.i.long(), edges.j.long()
    free_f = free.to(torch.float32)
    zero14 = torch.zeros(14, device=dev)

    def residual(xi_i, xi_j, s_c, R_c, t_c):                 # -> [E,7]
        Si = _retract(xi_i, s_c[ei], R_c[ei], t_c[ei])
        Sj = _retract(xi_j, s_c[ej], R_c[ej], t_c[ej])
        Sij = se3.sim3_compose(Si, se3.sim3_inverse(*Sj))
        se_, Re, te = se3.sim3_compose((edges.s, edges.R, edges.t),
                                       se3.sim3_inverse(*Sij))
        rot_err = torch.stack([Re[:, 2, 1] - Re[:, 1, 2],
                               Re[:, 0, 2] - Re[:, 2, 0],
                               Re[:, 1, 0] - Re[:, 0, 1]], dim=-1) * 0.5
        return torch.cat([te, rot_err,
                          torch.log(torch.clamp(se_, min=1e-9))[:, None]], dim=-1)

    # Where each edge's four 7x7 blocks land in H, as [K*K] block slots.
    slots = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    anchor = torch.repeat_interleave(1.0 - free_f, 7) * 1e6
    wf_i = edges.weight * free_f[ei]
    wf_j = edges.weight * free_f[ej]
    wf_ij = wf_i * free_f[ej]

    s_c, R_c, t_c = s_all, R_all, t_all
    n_guarded = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(iters):
        # Every edge's residual depends on its own two tangents only, so
        # the Jacobian with respect to ONE pair of tangents shared by all
        # edges, taken at zero, holds each edge's own two 7x7 blocks; the
        # residual comes out of the same pass.
        def both_ends(x):                                    # x [14]
            r = residual(x[:7].expand(E, 7), x[7:].expand(E, 7), s_c, R_c, t_c)
            return r, r

        J, r = jacfwd(both_ends, has_aux=True)(zero14)       # [E,7,14], [E,7]
        Ji, Jj = J[..., :7], J[..., 7:]
        Hii = torch.einsum("eki,e,ekj->eij", Ji, wf_i, Ji)
        Hjj = torch.einsum("eki,e,ekj->eij", Jj, wf_j, Jj)
        Hij = torch.einsum("eki,e,ekj->eij", Ji, wf_ij, Jj)
        bi = torch.einsum("eki,e,ek->ei", Ji, wf_i, r)
        bj = torch.einsum("eki,e,ek->ei", Jj, wf_j, r)
        H = torch.zeros((K * K, 7, 7), device=dev).index_add_(
            0, slots, torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)]))
        b = torch.zeros((K, 7), device=dev).index_add_(
            0, torch.cat([ei, ej]), torch.cat([bi, bj]))
        A = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        # Damping relative to H's own diagonal, BEFORE the gauge anchors:
        # a trace-scaled damping would pick up the 1e6 anchor entries and
        # swamp the O(1) curvature of the weight-1 edges, which freezes
        # the graph and leaves the loop error at the loop keyframe.
        A = A + torch.diag(1e-6 * torch.diagonal(A) + 1e-4)
        A = A + torch.diag(anchor)
        # solve_ex: no singularity check, which would wait for the device
        dx = -torch.linalg.solve_ex(A, b.reshape(-1)).result.reshape(K, 7)
        ok = torch.all(torch.isfinite(dx))
        n_guarded = n_guarded + (~ok).to(torch.int32)
        dx = torch.where(ok, dx, 0.0) * free_f[:, None]
        if fix_scale:
            dx = dx * (torch.arange(7, device=dev) < 6).to(torch.float32)
        s_c, R_c, t_c = _retract(dx, s_c, R_c, t_c)
    return s_c, R_c, t_c, n_guarded
