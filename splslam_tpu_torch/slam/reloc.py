"""Relocalization: BoW candidate scores and batched PnP / EPnL RANSAC
(port of splslam_tpu/slam/reloc.py).

The reference's LOST recovery (Tracking::Relocalization,
src/Tracking.cc:2895-3062, and RelocalizationBoth :3064-3314 with lines):
- candidates from the keyframe database: the L1 BoW score of the query
  frame against every keyframe's sparse BoW row (`reloc_scores`);
- per candidate (`reloc_attempt`): a global mutual descriptor match
  against the keyframe's landmarks, a minimal-DLT PnP RANSAC over a
  batch of 6-point hypotheses (`pnp_ransac`); with lines also a mutual
  LBD match against the keyframe's map lines and a 6-line EPnL RANSAC
  (`epnl_ransac`), whose pose seeds the solve when the point seed is
  weak; pose GN on both modalities, and the staged projection-search
  escalation when the inlier count lands in [8, 50);
- the host accepts at >= `reloc_min_inliers` (reference :3049), once an
  attempt.

Randomness: the minimal sets are drawn by `sample_minimal_sets` from an
explicit `torch.Generator` on the tensor's device (Gumbel top-k over the
valid correspondences: m distinct indices, uniformly). The draws differ
from the reference's PRNG; `pnp_ransac`, `epnl_ransac` and
`reloc_attempt` take the samples as arguments so they can be injected.

The reference's 12x12 and 3x3 SVDs become `ops/linalg.py`'s nullspace
vector (inverse iteration through an LU) and closest rotation (Jacobi),
because torch's SVD reads its convergence info back to the host on a
GPU; with the 3x3 determinants (an LU) nothing here reads a value back
to the host.
"""

from __future__ import annotations

import torch

from splslam_tpu_torch.bow.vocabulary import score_rows
from splslam_tpu_torch.geometry.camera import Camera, project_world
from splslam_tpu_torch.ops import match as M
from splslam_tpu_torch.ops.linalg import nullspace_vector, rotation_and_singular_values
from splslam_tpu_torch.optim.pose_gn import (CHI2_LINE, CHI2_POINT, LineObs, PointObs,
                                             line_coefficients, pose_optimize)
from splslam_tpu_torch.slam.frame import FrameData
from splslam_tpu_torch.slam.mapping_ops import _last_writer
from splslam_tpu_torch.slam.tracking import _scatter_rows

N_HYP = 192      # PnP hypotheses an attempt
N_HYP_LINES = 128  # EPnL hypotheses an attempt
ACCEPT = 50      # staged-search target (reference :3236-3297)


def reloc_scores(bow_ids: torch.Tensor, bow_vals: torch.Tensor,
                 kf_valid: torch.Tensor, query: torch.Tensor,
                 exclude: torch.Tensor) -> torch.Tensor:
    """[K] BoW scores of a dense query against the keyframe rows; -1 for
    invalid or excluded keyframes."""
    s = score_rows(bow_ids, bow_vals, query)
    return torch.where(kf_valid & ~exclude, s, -1.0)


def sample_minimal_sets(generator: torch.Generator, mask: torch.Tensor,
                        n_hyp: int, m: int) -> torch.Tensor:
    """[n_hyp, m] int64 minimal sets: per row, the m largest of Gumbel
    noise plus 0 (valid) or -1e9 (invalid) logits, i.e. m distinct valid
    indices uniformly (invalid ones only when fewer than m are valid)."""
    u = torch.rand((n_hyp, mask.shape[0]), generator=generator,
                   device=mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    logits = torch.where(mask, 0.0, -1e9)
    return torch.topk(g + logits[None], m, dim=1).indices


def _dlt_pnp(uvn: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Minimal DLT poses from 6 normalized-image points, batched: [H,6,2],
    [H,6,3] -> Tcw [H,4,4]. The nullspace vector P = [M | p]'s sign is
    fixed so that det(M) > 0, the rotation is the polar factor of M, and
    the scale is M's mean singular value."""
    x, y = uvn[..., 0:1], uvn[..., 1:2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)    # [H,6,4]
    z = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, z, -x * Xh], dim=-1),
                   torch.cat([z, Xh, -y * Xh], dim=-1)], dim=-2)  # [H,12,12]
    return _pose_from_dlt(A)


def _pose_from_dlt(A: torch.Tensor) -> torch.Tensor:
    """[H,12,12] DLT systems on the 12 entries of P = [M | p] -> Tcw
    [H,4,4]: the nullspace vector, its sign fixed so that det(M) > 0, the
    rotation the polar factor of M, the scale M's mean singular value."""
    P = nullspace_vector(A).reshape(-1, 3, 4)
    P = P * torch.sign(torch.linalg.det(P[..., :3]))[:, None, None]
    R, s = rotation_and_singular_values(P[..., :3])
    T = torch.eye(4, device=A.device).repeat(P.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = (P[..., 3]
                   / torch.clamp(torch.mean(s, dim=-1), min=1e-12)[:, None])
    return T


def _dlt_pose_from_lines(coef_n: torch.Tensor, X3: torch.Tensor) -> torch.Tensor:
    """Minimal poses from 6 line correspondences, batched: normalized-image
    line coefficients [H,6,3] and the lines' world start/end points
    [H,6,2,3] -> Tcw [H,4,4]. A 3D point on an observed 2D line l gives
    one linear constraint l . (P X_h) = 0 on the 12 entries of P, so 6
    lines (both endpoints) give the 12x12 system (the reference's EPnL,
    src/PnPsolver.cc:960 compute_pose_Lines, solves with control points)."""
    H = coef_n.shape[0]
    Xh = torch.cat([X3, torch.ones_like(X3[..., :1])], dim=-1).reshape(H, 12, 4)
    lf = coef_n[:, :, None, :].expand(H, 6, 2, 3).reshape(H, 12, 3)
    A = torch.cat([lf[..., 0:1] * Xh, lf[..., 1:2] * Xh, lf[..., 2:3] * Xh],
                  dim=-1)                                            # [H,12,12]
    return _pose_from_dlt(A)


def _pnp_inliers(T, cam: Camera, uv, xyz, inv_sigma2, mask):
    """Inlier mask of pose(s) T [...,4,4] at the 2-dof chi2 gate."""
    pc = xyz @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z > 1e-6, z, 1e-6)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
    return mask & (z > 1e-6) & (chi2 <= CHI2_POINT)


def pnp_ransac(cam: Camera, uv: torch.Tensor, xyz: torch.Tensor,
               inv_sigma2: torch.Tensor, mask: torch.Tensor,
               samples: torch.Tensor):
    """Batched minimal PnP RANSAC over the hypotheses `samples` [H,6].
    Returns (Tcw, n_inliers, inlier mask) of the first hypothesis with
    the most inliers."""
    uvn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                       (uv[:, 1] - cam.cy) / cam.fy], dim=-1)
    idx = samples.long()
    Ts = _dlt_pnp(uvn[idx], xyz[idx])
    counts = torch.sum(_pnp_inliers(Ts, cam, uv, xyz, inv_sigma2, mask)
                       .to(torch.int32), dim=-1)
    best = torch.argmax(counts)[None]      # a 1-d index gathers on the device
    T = Ts[best][0]
    return T, counts[best][0], _pnp_inliers(T, cam, uv, xyz, inv_sigma2, mask)


def _epnl_inliers(T, cam: Camera, coef, mid, mask):
    """Inlier mask of pose(s) T [...,4,4]: the midpoint's line residual
    at 2 px sigma against the 1-dof chi2 gate (the reference's
    CheckInlierLines, src/PnPsolver.cc:610)."""
    pc = mid @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z > 1e-6, z, 1e-6)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    r = coef[:, 0] * u + coef[:, 1] * v + coef[:, 2]
    return mask & (z > 1e-6) & (r * r * 0.25 <= CHI2_LINE)


def epnl_ransac(cam: Camera, coef: torch.Tensor, xyz3: torch.Tensor,
                mask: torch.Tensor, samples: torch.Tensor):
    """Line-only minimal RANSAC (the reference's EPnL, PnPsolver::
    iterateLines src/PnPsolver.cc:367-447) over the 6-line hypotheses
    `samples` [H,6]: `coef` [L,3] the observed pixel line coefficients,
    `xyz3` [L,3,3] the matched map lines' start/mid/end. Returns (Tcw,
    n_inliers, inlier mask) of the first hypothesis with the most
    inliers."""
    # The lines in normalized image coordinates: l' = K^T l.
    lp = torch.stack([coef[:, 0] * cam.fx, coef[:, 1] * cam.fy,
                      coef[:, 0] * cam.cx + coef[:, 1] * cam.cy + coef[:, 2]], dim=-1)
    idx = samples.long()
    ends = xyz3[idx]                                                  # [H,6,3,3]
    Ts = _dlt_pose_from_lines(lp[idx], torch.stack([ends[..., 0, :], ends[..., 2, :]],
                                                   dim=-2))
    mid = xyz3[:, 1]
    counts = torch.sum(_epnl_inliers(Ts, cam, coef, mid, mask).to(torch.int32),
                       dim=-1)
    best = torch.argmax(counts)[None]      # a 1-d index gathers on the device
    T = Ts[best][0]
    return T, counts[best][0], _epnl_inliers(T, cam, coef, mid, mask)


def global_match(frame: FrameData, kf_desc, kf_fvalid, kf_lm, kf_lm_xyz):
    """Mutual descriptor match of the keyframe's landmark rows against the
    frame (SearchByBoW equivalent; columns unique). Returns (dist
    [N_kf, N_cur], assoc_gid [N], assoc_xyz [N,3])."""
    N = frame.feat.capacity
    dev = kf_lm.device
    dist = M.hamming(kf_desc, frame.feat.desc)
    d1 = M.masked_distances(dist, kf_fvalid & (kf_lm >= 0), frame.feat.valid)
    mt, _ = M.nn_match(d1, max_dist=M.TH_LOW, ratio=0.75, mutual=True)
    rows_ok = mt >= 0
    assoc_gid = _scatter_rows(N, mt, rows_ok, torch.where(rows_ok, kf_lm, -1),
                              torch.full((N,), -1, dtype=torch.int32, device=dev))
    assoc_xyz = _scatter_rows(N, mt, rows_ok, kf_lm_xyz,
                              torch.zeros((N, 3), device=dev))
    return dist, assoc_gid, assoc_xyz


def proj_round(cam: Camera, frame: FrameData, dist, kf_fvalid, kf_lm,
               kf_lm_xyz, Tcw, gid_c, xyz_c, window: float,
               ln_obs: LineObs | None = None):
    """One projection-search round: project the keyframe's landmarks with
    Tcw, match them in a `window` px box against the frame's still-free
    keypoints, add the hits to the associations and re-solve the pose.
    The match is not mutual, so several keyframe rows may pick one
    column: the highest row wins, as the reference's scatter keeps its
    last write. `ln_obs`: the line rows of the solve (None: points only).
    Returns (PoseOptResult, gid [N], xyz [N,3])."""
    uv, z = project_world(cam, Tcw, kf_lm_xyz)
    row_ok = (kf_lm >= 0) & kf_fvalid & (z > 0.1)
    wmask = M.window_mask(uv, frame.feat.xy, window)
    d2 = M.masked_distances(dist, row_ok, frame.feat.valid & (gid_c < 0), wmask)
    mt2, _ = M.nn_match(d2, max_dist=M.TH_HIGH)
    w = _last_writer(mt2, mt2 >= 0, frame.feat.capacity)
    hit = w >= 0
    ws = w.clamp(min=0)
    gid = torch.where(hit, kf_lm[ws], gid_c)
    xyz = torch.where(hit[:, None], kf_lm_xyz[ws], xyz_c)
    r = pose_optimize(Tcw, cam, PointObs(
        xyz_w=xyz, uv=frame.feat.xy, inv_sigma2=1.0 / frame.feat.sigma2,
        mask=gid >= 0, ur=frame.u_right), ln_obs)
    return r, gid, xyz


def line_match(frame: FrameData, kf_ldesc, kf_ll, kf_ll_xyz3):
    """Mutual LBD match of the candidate keyframe's map lines against the
    frame's lines at TH_HIGH (the reference's SearchByKNNLines,
    src/Tracking.cc:3115-3121; columns unique). Returns (ll_gid [Lc],
    ll_xyz3 [Lc,3,3])."""
    Lc = frame.lines.capacity
    dev = kf_ll.device
    d = M.masked_distances(M.hamming(kf_ldesc, frame.lines.desc), kf_ll >= 0,
                           frame.lines.valid)
    mt, _ = M.nn_match(d, max_dist=M.TH_HIGH, mutual=True)
    ok = mt >= 0
    ll_gid = _scatter_rows(Lc, mt, ok, torch.where(ok, kf_ll, -1),
                           torch.full((Lc,), -1, dtype=torch.int32, device=dev))
    ll_xyz3 = _scatter_rows(Lc, mt, ok, kf_ll_xyz3,
                            torch.zeros((Lc, 3, 3), device=dev))
    return ll_gid, ll_xyz3


def reloc_attempt(
    cam: Camera,
    frame: FrameData,
    kf_desc: torch.Tensor,    # [N,8] candidate keyframe descriptors
    kf_fvalid: torch.Tensor,  # [N]
    kf_lm: torch.Tensor,      # [N] landmark ids (-1 none)
    kf_lm_xyz: torch.Tensor,  # [N,3]
    kf_ldesc: torch.Tensor | None = None,    # [Lk,8] candidate's LBD descriptors
    kf_ll: torch.Tensor | None = None,       # [Lk] map-line ids (-1 none)
    kf_ll_xyz3: torch.Tensor | None = None,  # [Lk,3,3] their start/mid/end
    *,
    generator: torch.Generator | None = None,
    samples: torch.Tensor | None = None,
    line_samples: torch.Tensor | None = None,
):
    """One relocalization attempt against one candidate keyframe (the
    reference's RelocalizationBoth staging, src/Tracking.cc:3064-3314):
    mutual descriptor match and PnP RANSAC seed; when the frame has a
    line table (capacity > 1) and the candidate's lines are given, the
    mutual line match and the EPnL RANSAC seed too, which replaces the
    point seed when that is weak (< 12 inliers against >= 6 line
    inliers, and more than half the point count) and then lets back only
    the points that reproject within 3x the chi2 gate under it; pose GN
    on points and line midpoints; then two projection-search rounds
    (windows 10 and 16 px) taken when the count lands in [8, 50) and they
    raise it. The minimal sets are `samples` ([N_HYP,6] points) and
    `line_samples` ([N_HYP_LINES,6] lines) if given, else drawn from
    `generator` in that order. Returns (Tcw, n_inliers, lm_gid [N],
    ll_gid [Lc])."""
    Lc = frame.lines.capacity
    dev = kf_lm.device
    dist, assoc_gid, assoc_xyz = global_match(frame, kf_desc, kf_fvalid, kf_lm,
                                              kf_lm_xyz)
    has = assoc_gid >= 0
    with_lines = Lc > 1 and kf_ll is not None
    if with_lines:
        ll_gid, ll_xyz3 = line_match(frame, kf_ldesc, kf_ll, kf_ll_xyz3)
    else:
        ll_gid = torch.full((Lc,), -1, dtype=torch.int32, device=dev)
    if samples is None:
        samples = sample_minimal_sets(generator, has, N_HYP, 6)
    inv_sig2 = 1.0 / frame.feat.sigma2
    T0, n0, inl0 = pnp_ransac(cam, frame.feat.xy, assoc_xyz, inv_sig2, has,
                              samples)
    ln_obs = None
    if with_lines:
        coef = line_coefficients(frame.lines.seg)
        lmask = (ll_gid >= 0) & frame.lines.valid
        if line_samples is None:
            line_samples = sample_minimal_sets(generator, lmask, N_HYP_LINES, 6)
        TL, nL, _ = epnl_ransac(cam, coef, ll_xyz3, lmask, line_samples)
        # The point seed anchors 2 dof an inlier, a line 1: points win
        # unless weak (the reference escalates to EPnL when EPnP fails,
        # :3160-3235).
        use_lines = (n0 < 12) & (nL >= 6) & (2 * nL > n0)
        T0 = torch.where(use_lines, TL, T0)
        # Under a line seed the points re-enter only where they reproject
        # within a loose 3x gate, so a wrong seed keeps no point support.
        uvL, zL = project_world(cam, TL, assoc_xyz)
        chiL = torch.sum((uvL - frame.feat.xy) ** 2, dim=-1) / frame.feat.sigma2
        inl0 = torch.where(use_lines, has & (zL > 0.1) & (chiL <= 3.0 * CHI2_POINT),
                           inl0)
        ln_obs = LineObs(mid_w=ll_xyz3[:, 1], coef=coef,
                         inv_sigma2=torch.full((Lc,), 0.25, device=dev), mask=lmask)
    res = pose_optimize(T0, cam, PointObs(
        xyz_w=assoc_xyz, uv=frame.feat.xy, inv_sigma2=inv_sig2,
        mask=has & inl0, ur=frame.u_right), ln_obs)
    inlier = res.inlier_pt & has
    n_in = torch.sum(inlier.to(torch.int32))

    args = (cam, frame, dist, kf_fvalid, kf_lm, kf_lm_xyz)
    short = (n_in < ACCEPT) & (n_in >= 8)
    res2, gid2, xyz2 = proj_round(*args, res.Tcw, assoc_gid, assoc_xyz, 10.0, ln_obs)
    in2 = res2.inlier_pt & (gid2 >= 0)
    n2 = torch.sum(in2.to(torch.int32))
    # TwiceSearch: a wider window when still short
    res3, gid3, _ = proj_round(*args, res2.Tcw, gid2, xyz2, 16.0, ln_obs)
    in3 = res3.inlier_pt & (gid3 >= 0)
    n3 = torch.sum(in3.to(torch.int32))
    use3 = short & (n2 < ACCEPT) & (n3 > n2)
    use2 = short & ~use3 & (n2 > n_in)

    def pick(a, b, c):
        return torch.where(use3, c, torch.where(use2, b, a))

    if with_lines:
        ln_in = pick(res.inlier_ln, res2.inlier_ln, res3.inlier_ln) & (ll_gid >= 0)
        ll_gid = torch.where(ln_in, ll_gid, -1)
    return (
        pick(res.Tcw, res2.Tcw, res3.Tcw),
        pick(n_in, n2, n3),
        pick(torch.where(inlier, assoc_gid, -1), torch.where(in2, gid2, -1),
             torch.where(in3, gid3, -1)),
        ll_gid,
    )
