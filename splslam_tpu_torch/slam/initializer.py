"""Monocular two-view initialization: unified point + line-midpoint RANSAC
(port of splslam_tpu/slam/initializer.py; reference src/Initializer.cc).

Point matches and line-midpoint matches share one index space (reference
InitializeBoth, :131-252). `n_hyp` hypotheses of 8 correspondences each
give a fundamental matrix (8-point) and a homography (DLT); every
hypothesis is scored by symmetric transfer over all correspondences; the
best of each model is refit on its inliers; the model is chosen by
RH = SH / (SH + SF) > 0.40 (:218-224); its motion candidates (4 from E,
8 from H) are scored by cheirality / parallax / reprojection checks
(ReconstructF :1127, ReconstructH :1248).

The hypotheses are an argument (`samples` [n_hyp, 8] row indices): torch
cannot reproduce the reference's `jax.random` draws, so the caller draws
them (`slam/mono.py::draw_init_samples`) and a test can pass the
reference's own. The SVD and eigh of the reference are computed without
them, as every decomposition of the port is (`ops/linalg.py`: a host-side
convergence check would stall the GPU): null vectors by inverse iteration
in float64, 3x3 SVDs by Jacobi. Singular vectors are unique only up to
sign (and rotation within repeated singular values); the candidate
motions built from them are not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.ops.linalg import nullspace_vector, svd3

TH_CHI2 = 3.841      # 1-dof 95% gate on transfer error (reference :430)
TH_SCORE = 5.991     # score contribution cap (reference CheckFundamental)
SIGMA = 1.0


class TwoViewResult(NamedTuple):
    ok: torch.Tensor          # 0-dim bool
    used_h: torch.Tensor      # 0-dim bool — homography model chosen
    R21: torch.Tensor         # (3,3) rotation cam1 -> cam2
    t21: torch.Tensor         # (3,) unit-norm translation
    xyz: torch.Tensor         # [M,3] triangulated points (cam-1 frame)
    good: torch.Tensor        # [M] bool triangulation inliers
    n_good: torch.Tensor
    parallax: torch.Tensor    # median parallax (deg) of the good set


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _inv(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(M).inverse


def _normalize(xy: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization (reference NormalizeBoth :1842). Returns
    (normalized xy, T 3x3 with xn = T x)."""
    w = mask.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    md = torch.sum(torch.abs(xy - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    z = torch.zeros_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, z + 1.0])])
    return (xy - mean) * s, T


def _rows_f(x1n, x2n):
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _rows_h(x1n, x2n):
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, one, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _min_vector(A: torch.Tensor) -> torch.Tensor:
    """[...,m,9] -> [...,9]: the right singular vector of A's smallest
    singular value (the eigenvector of A^T A's smallest eigenvalue)."""
    Ad = A.double()
    return nullspace_vector(Ad.transpose(-1, -2) @ Ad).to(A.dtype)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """Zero the smallest singular value of [...,3,3]."""
    U, s, V = svd3(F)
    return ((U[..., :, :2] * s[..., None, :2]) @ V[..., :, :2].transpose(-1, -2)).to(F.dtype)


def _solve_f(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """8-point fundamental from [...,8,2] normalized points; rank 2."""
    return _rank2(_min_vector(_rows_f(x1n, x2n)).reshape(*x1n.shape[:-2], 3, 3))


def _solve_h(x1n: torch.Tensor, x2n: torch.Tensor) -> torch.Tensor:
    """DLT homography from 8 correspondences (over-determined)."""
    return _min_vector(_rows_h(x1n, x2n)).reshape(*x1n.shape[:-2], 3, 3)


def _homog(xy):
    return torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)


def _score_f(F, xy1, xy2, mask, inv_s2_row=None):
    """Symmetric epipolar-distance score (reference CheckFundamentalBoth
    :430-499), batched over leading axes of F [...,3,3]."""
    x1, x2 = _homog(xy1), _homog(xy2)
    l2 = x1 @ F.transpose(-1, -2)     # line in img2
    l1 = x2 @ F                       # line in img1
    d2 = torch.sum(l2 * x2, dim=-1) ** 2 / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = torch.sum(l1 * x1, dim=-1) ** 2 / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    inv_s2 = 1.0 / (SIGMA * SIGMA) if inv_s2_row is None else inv_s2_row
    c1, c2 = d1 * inv_s2, d2 * inv_s2
    in1 = (c1 <= TH_CHI2) & mask
    in2 = (c2 <= TH_CHI2) & mask
    score = (torch.sum(torch.where(in1, TH_SCORE - c1, 0.0), dim=-1)
             + torch.sum(torch.where(in2, TH_SCORE - c2, 0.0), dim=-1))
    return score, in1 & in2


def _score_h(Hm, xy1, xy2, mask, inv_s2_row=None):
    """Symmetric transfer score for H (reference CheckHomographyBoth
    :309-377), chi2 gate 5.991 both ways."""
    x1, x2 = _homog(xy1), _homog(xy2)
    Hinv = _inv(Hm + 1e-12 * torch.eye(3, device=Hm.device))
    p2 = x1 @ Hm.transpose(-1, -2)
    p1 = x2 @ Hinv.transpose(-1, -2)
    p2 = p2[..., :2] / torch.where(torch.abs(p2[..., 2:]) < 1e-9, 1e-9, p2[..., 2:])
    p1 = p1[..., :2] / torch.where(torch.abs(p1[..., 2:]) < 1e-9, 1e-9, p1[..., 2:])
    inv_s2 = 1.0 / (SIGMA * SIGMA) if inv_s2_row is None else inv_s2_row
    c2 = torch.sum((p2 - xy2) ** 2, dim=-1) * inv_s2
    c1 = torch.sum((p1 - xy1) ** 2, dim=-1) * inv_s2
    th = 5.991
    in1 = (c1 <= th) & mask
    in2 = (c2 <= th) & mask
    score = (torch.sum(torch.where(in1, th - c1, 0.0), dim=-1)
             + torch.sum(torch.where(in2, th - c2, 0.0), dim=-1))
    return score, in1 & in2


def dlt_points(P1: torch.Tensor, P2: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Linear triangulation of pixel pairs a, b [...,2] seen by the 3x4
    projections P1, P2 (broadcast over leading axes). [...,3]."""
    A = torch.stack([a[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
                     a[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
                     b[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
                     b[..., 1, None] * P2[..., 2, :] - P2[..., 1, :]], dim=-2)
    X = nullspace_vector(A)
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)


def _check_rt(R, t, K, xy1, xy2, mask, th2: float = 16.0):
    """CheckRT (reference :1857-2022) for candidates R [C,3,3], t [C,3]:
    cheirality in both views, finite parallax, reprojection error < th2
    in both images. Returns (n_good [C], good [C,M], parallax_deg [C],
    xyz [C,M,3])."""
    C = R.shape[0]
    eye34 = torch.eye(3, 4, device=R.device)
    P1 = (K @ eye34).expand(C, 1, 3, 4)
    P2 = (K @ torch.cat([R, t[:, :, None]], dim=-1))[:, None]
    xyz = dlt_points(P1, P2, xy1[None], xy2[None])          # [C,M,3]
    z1 = xyz[..., 2]
    p2 = xyz @ R.transpose(-1, -2) + t[:, None, :]
    z2 = p2[..., 2]
    O2 = -(R.transpose(-1, -2) @ t[:, :, None])[:, None, :, 0]
    n1 = torch.sqrt(torch.sum(xyz * xyz, dim=-1))
    d = xyz - O2
    n2 = torch.sqrt(torch.sum(d * d, dim=-1))
    cosp = torch.sum(xyz * d, dim=-1) / torch.clamp(n1 * n2, min=1e-9)

    def reproj(pc, xy):
        zs = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
        u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
        v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
        return (u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2

    e1 = reproj(xyz, xy1)
    e2 = reproj(p2, xy2)
    finite = torch.all(torch.isfinite(xyz), dim=-1)
    good = (mask & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < th2) & (e2 < th2))
    n_good = torch.sum(good.to(torch.int32), dim=-1)
    # parallax at the 50th-smallest cosine of the good points
    cos_sorted = torch.sort(torch.where(good, cosp, 1.0), dim=-1).values
    idx = torch.clamp(torch.clamp(n_good - 1, max=50), 0, cosp.shape[-1] - 1)
    c = torch.gather(cos_sorted, 1, idx[:, None].long())[:, 0]
    parallax = torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))
    return n_good, good, parallax, xyz


def _decompose_h(Hm: torch.Tensor, K: torch.Tensor):
    """Faugeras decomposition of a homography into 8 candidate motions
    (reference ReconstructH :1248-1574). Returns (R [8,3,3], t [8,3])."""
    U, w, V = svd3(_inv(K) @ Hm @ K)
    dt = w.dtype
    Vt = V.T
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = w[0], w[1], w[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    sgn = torch.sign(x1s * x3s + 1e-30)
    zero = torch.zeros(4, dtype=dt, device=Hm.device)
    one = zero + 1.0
    # case d' > 0
    st_ = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    sth = st_ * sgn
    Rp_a = torch.stack([torch.stack([ct + zero, zero, -sth], -1),
                        torch.stack([zero, one, zero], -1),
                        torch.stack([sth, zero, ct + zero], -1)], -2)
    tp_a = (d1 - d3) * torch.stack([x1s, zero, -x3s], -1)
    # case d' < 0
    sphi = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    cphi = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    sph = sphi * sgn
    Rp_b = torch.stack([torch.stack([cphi + zero, zero, sph], -1),
                        torch.stack([zero, -one, zero], -1),
                        torch.stack([sph, zero, -cphi + zero], -1)], -2)
    tp_b = (d1 + d3) * torch.stack([x1s, zero, x3s], -1)
    Rp = torch.cat([Rp_a, Rp_b])
    tp = torch.cat([tp_a, tp_b])
    R8 = s * U @ Rp @ Vt
    t8 = tp @ U.T
    t8 = t8 / torch.clamp(torch.linalg.vector_norm(t8, dim=-1, keepdim=True), min=1e-12)
    return R8.to(Hm.dtype), t8.to(Hm.dtype)


def _decompose_e(F: torch.Tensor, K: torch.Tensor):
    """E = K^T F K -> the 4 candidate motions (reference ReconstructF +
    DecomposeE :1127-1246, :2162-2188). Returns (R [4,3,3], t [4,3])."""
    U, _, V = svd3(K.T @ F @ K)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = V.T * torch.sign(torch.linalg.det(V))
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=U.dtype).to(F.device, non_blocking=True)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[:, 2] / torch.clamp(torch.linalg.vector_norm(U[:, 2]), min=1e-12)
    return (torch.stack([R1, R1, R2, R2]).to(F.dtype),
            torch.stack([t, -t, t, -t]).to(F.dtype))


def two_view_init(
    samples: torch.Tensor,   # [n_hyp, 8] row indices of valid correspondences
    xy1: torch.Tensor,       # [M,2] view-1 coords of unified correspondences
    xy2: torch.Tensor,       # [M,2] view-2 coords
    mask: torch.Tensor,      # [M] bool — correspondence exists
    K: torch.Tensor,         # (3,3) intrinsics
    inv_sigma2: torch.Tensor | None = None,  # [M] per-row 1/sigma^2
) -> TwoViewResult:
    """The unified point+midpoint RANSAC, model selection and
    reconstruction. Nothing is read back to the host."""
    n_match = torch.sum(mask.to(torch.int32))
    x1n, T1 = _normalize(xy1, mask)
    x2n, T2 = _normalize(xy2, mask)
    T2i = _inv(T2)

    idx = samples.long()
    a1, a2 = x1n[idx], x2n[idx]                     # [n_hyp,8,2]
    Fs = T2.T @ _solve_f(a1, a2) @ T1
    Hs = T2i @ _solve_h(a1, a2) @ T1
    sf, _ = _score_f(Fs[:, None], xy1, xy2, mask, inv_sigma2)
    sh, _ = _score_h(Hs[:, None], xy1, xy2, mask, inv_sigma2)
    best_f = torch.argmax(sf)
    best_h = torch.argmax(sh)
    F = _take(Fs, best_f)
    Hm = _take(Hs, best_h)
    sf_b = _take(sf, best_f)
    sh_b = _take(sh, best_h)

    # refit each best model on all of its inliers (least-squares null
    # vector of the inlier rows)
    _, in_f0 = _score_f(F, xy1, xy2, mask, inv_sigma2)
    _, in_h0 = _score_h(Hm, xy1, xy2, mask, inv_sigma2)
    F2 = T2.T @ _rank2(_min_vector(
        _rows_f(x1n, x2n) * in_f0.to(torch.float32)[:, None]).reshape(3, 3)) @ T1
    wh = in_h0.to(torch.float32)[:, None]
    H2 = T2i @ _min_vector(_rows_h(x1n, x2n) * torch.cat([wh, wh])).reshape(3, 3) @ T1
    sf2, _ = _score_f(F2, xy1, xy2, mask, inv_sigma2)
    sh2, _ = _score_h(H2, xy1, xy2, mask, inv_sigma2)
    F = torch.where(sf2 >= sf_b, F2, F)
    Hm = torch.where(sh2 >= sh_b, H2, Hm)
    SF = torch.maximum(sf2, sf_b)
    SH = torch.maximum(sh2, sh_b)
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40   # reference :218-224

    _, in_f = _score_f(F, xy1, xy2, mask, inv_sigma2)
    _, in_h = _score_h(Hm, xy1, xy2, mask, inv_sigma2)
    inliers = torch.where(use_h, in_h, in_f)

    R4, t4 = _decompose_e(F, K)
    R8h, t8h = _decompose_h(Hm, K)
    R8 = torch.where(use_h, R8h, torch.cat([R4, R4]))
    t8 = torch.where(use_h, t8h, torch.cat([t4, t4]))
    # the F model has 4 distinct candidates; its duplicate slots are out
    slot_ok = use_h | (torch.arange(8, device=K.device) < 4)
    n_good, good, par, xyz = _check_rt(R8, t8, K, xy1, xy2, inliers)
    n_good = torch.where(slot_ok, n_good, -1)

    best = torch.argmax(n_good)
    n_best = _take(n_good, best)
    second = torch.sort(n_good).values[-2]
    n_inl = torch.sum(inliers.to(torch.int32))
    par_b = _take(par, best)
    ok = ((n_best >= 0.8 * n_inl.to(torch.float32))
          & (second < 0.75 * n_best.to(torch.float32))
          & (n_best > 30) & (par_b > 0.5) & (n_match >= 30))
    return TwoViewResult(ok=ok, used_h=use_h, R21=_take(R8, best),
                         t21=_take(t8, best), xyz=_take(xyz, best),
                         good=_take(good, best), n_good=n_best, parallax=par_b)


def gumbel_samples(mask: torch.Tensor, n_hyp: int,
                   generator: torch.Generator) -> torch.Tensor:
    """[n_hyp, 8] int64: per hypothesis, 8 distinct rows drawn uniformly
    among the valid ones (Gumbel top-k, the reference's scheme)."""
    M = mask.shape[0]
    u = torch.rand((n_hyp, M), generator=generator, device=mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20, max=1.0 - 1e-7)))
    g = g + torch.where(mask, 0.0, -1e9)[None]
    return torch.topk(g, 8, dim=1).indices

