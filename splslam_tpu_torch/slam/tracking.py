"""Front-end tracking step (port of splslam_tpu/slam/tracking.py, points
only): motion-model projection match -> seed pose GN -> local-map
frustum cull + projection match -> full pose GN -> inlier counts and
per-feature landmark associations. Plus the reference-keyframe fallback
match (`bow_free_refkf_match`).

Row->column scatters that the reference writes with `mode="drop"` go
into an `n+1` buffer whose spare slot is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops import match as M
from splslam_tpu_torch.optim.pose_gn import PointObs, pose_optimize
from splslam_tpu_torch.slam.frame import LINES_LATER, FrameData
from splslam_tpu_torch.slam.map import predict_octave


class LocalWindow(NamedTuple):
    """Padded slice of the landmark table visible to the tracker."""

    ids: torch.Tensor     # [M] int32 global landmark ids (-1 pad)
    xyz: torch.Tensor     # [M,3]
    desc: torch.Tensor    # [M,8] int32
    normal: torch.Tensor  # [M,3]
    dmin: torch.Tensor    # [M]
    dmax: torch.Tensor    # [M]
    ok: torch.Tensor      # [M] bool


class TrackResult(NamedTuple):
    Tcw: torch.Tensor           # (4,4) final pose
    lm_gid: torch.Tensor        # [N] global landmark id per cur keypoint (-1)
    inlier: torch.Tensor        # [N] bool (has landmark & survived final GN)
    n_mm_matches: torch.Tensor  # matches from the motion model stage
    n_inliers: torch.Tensor     # final inlier count (mnMatchesInliers)
    visible_ids: torch.Tensor   # [M] local ids seen in frustum (-1 where not)
    found_ids: torch.Tensor     # [M] local ids actually matched (-1 where not)
    ll_gid: torch.Tensor        # [L] map-line id per line feature (all -1)
    ln_inlier: torch.Tensor     # [L] bool (all False)
    n_ln_inliers: torch.Tensor  # 0


def _resolve_columns(matches: torch.Tensor, dists: torch.Tensor, n_cols: int):
    """Row->col matches may collide on a column; keep the best row per
    column (composite key dist*R + row, scatter-min, so ties break to
    the lower row). Losers become -1."""
    R = matches.shape[0]
    rows = torch.arange(R, dtype=torch.int32, device=matches.device)
    ok = matches >= 0
    key = torch.where(ok, dists, 0).to(torch.int32) * R + rows
    col_key = torch.full((n_cols + 1,), M.INT32_MAX, dtype=torch.int32,
                         device=matches.device)
    col_key.scatter_reduce_(0, torch.where(ok, matches, n_cols).long(),
                            torch.where(ok, key, M.INT32_MAX), "amin")
    win = ok & (col_key[matches.clamp(min=0).long()] == key)
    return torch.where(win, matches, -1)


def _scatter_rows(n: int, cols: torch.Tensor, ok: torch.Tensor,
                  values: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """base[cols[r]] = values[r] for rows with ok (columns unique among
    them); other rows write a spare slot that is dropped."""
    buf = torch.cat([base, base[:1]])
    buf[torch.where(ok, cols, n).long()] = values.to(base.dtype)
    return buf[:n]


def _project(Tcw, cam: Camera, xyz):
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    pc = xyz @ R.T + t
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * pc[:, 0] / zs + cam.cx
    v = cam.fy * pc[:, 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1), z


def _ur_gate(cam: Camera, uv_pred, z, cur_ur, radius):
    """Stereo right-coordinate candidate gate: for keypoints with ur >= 0
    require |u_pred - bf/z - ur| <= radius; mono keypoints are exempt."""
    ur_pred = uv_pred[:, 0] - cam.bf / torch.clamp(z, min=1e-6)
    err = torch.abs(ur_pred[:, None] - cur_ur[None, :])
    if isinstance(radius, torch.Tensor) and radius.dim() == 1:
        radius = radius[:, None]
    return (cur_ur[None, :] < 0) | (err <= radius)


def _in_img(cam: Camera, uv):
    return ((uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))


def motion_model_match(cam: Camera, scales, T_pred, cur: FrameData, last_octave,
                       last_angle, last_desc, last_lm_xyz, last_lm_ok, th: float):
    """SearchByProjection(cur, last, th): project last frame's landmarks
    with the predicted pose, window-search the current frame. Returns
    (row->col matches [N_last], dists)."""
    uv_pred, z = _project(T_pred, cam, last_lm_xyz)
    row_ok = last_lm_ok & (z > 0.1) & _in_img(cam, uv_pred)
    radius = th * scales[last_octave.long()]
    win = M.window_mask(uv_pred, cur.feat.xy, radius)
    oct_ok = M.octave_mask(last_octave, cur.feat.octave, -1, 1)
    ur_ok = _ur_gate(cam, uv_pred, z, cur.u_right, radius)
    dist = M.hamming(last_desc, cur.feat.desc)
    dist = M.masked_distances(dist, row_ok, cur.feat.valid, win & oct_ok & ur_ok)
    mt, md = M.nn_match(dist, max_dist=M.TH_HIGH)
    mt = M.rotation_consistency(last_angle, cur.feat.angle, mt)
    mt = _resolve_columns(mt, md, cur.feat.capacity)
    return mt, md


def local_map_match(cam: Camera, scales, Tcw, cur: FrameData, win: LocalWindow,
                    already, scale_factor: float, n_levels: int, th: float = 4.0):
    """SearchLocalPoints + SearchByProjection(F, vpMapPoints): frustum cull
    the window, project, window-search unmatched keypoints. Returns
    (matches [M] row->cur-col, visible [M], dists [M])."""
    uv, z = _project(Tcw, cam, win.xyz)
    Twc_t = -Tcw[:3, :3].T @ Tcw[:3, 3]
    view = win.xyz - Twc_t
    dist3 = torch.linalg.norm(view, dim=-1)
    viewcos = torch.sum(view * win.normal, dim=-1) / torch.clamp(dist3, min=1e-9)
    visible = (
        win.ok
        & (z > 0.1)
        & _in_img(cam, uv)
        & (dist3 > 0.8 * win.dmin)
        & (dist3 < 1.2 * win.dmax)
        & (viewcos > 0.5)
    )
    pred_oct = predict_octave(dist3, win.dmax, scale_factor, n_levels)
    radius = torch.where(viewcos > 0.998, 2.5, th) * scales[pred_oct.long()]
    wmask = M.window_mask(uv, cur.feat.xy, radius)
    omask = M.octave_mask(pred_oct, cur.feat.octave, -1, 1)
    ur_ok = _ur_gate(cam, uv, z, cur.u_right, radius)
    dist = M.hamming(win.desc, cur.feat.desc)
    dist = M.masked_distances(dist, visible, cur.feat.valid & ~already,
                              wmask & omask & ur_ok)
    mt, md = M.nn_match(dist, max_dist=M.TH_HIGH, ratio=0.8)
    mt = _resolve_columns(mt, md, cur.feat.capacity)
    return mt, visible, md


def _no_lines(cur: FrameData):
    L = cur.lines.capacity
    if L > 1:
        raise NotImplementedError(LINES_LATER)
    dev = cur.u_right.device
    return (torch.full((L,), -1, dtype=torch.int32, device=dev),
            torch.zeros((L,), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def track_step(
    cam: Camera,
    scales: torch.Tensor,
    cur: FrameData,
    last_octave: torch.Tensor,
    last_angle: torch.Tensor,
    last_desc: torch.Tensor,
    last_lm_xyz: torch.Tensor,
    last_lm_gid: torch.Tensor,
    T_pred: torch.Tensor,
    win: LocalWindow,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    th_motion: float = 7.0,
    th_local: float = 4.0,
    gn_rounds: int = 4,
    gn_iters: int = 6,
) -> TrackResult:
    """One tracking step: the reference's TrackWithMotionModel +
    TrackLocalMap (src/Tracking.cc:1773-2108), points only."""
    ll_gid, ln_inlier, n_ln = _no_lines(cur)
    N = cur.feat.capacity
    dev = T_pred.device
    inv_sig2 = 1.0 / cur.feat.sigma2

    # ---- stage 1: motion model ----
    mm, _ = motion_model_match(
        cam, scales, T_pred, cur, last_octave, last_angle, last_desc,
        last_lm_xyz, last_lm_gid != -1, th_motion,
    )
    rows_ok = mm >= 0
    assoc_gid = _scatter_rows(
        N, mm, rows_ok, torch.where(rows_ok, last_lm_gid, -1),
        torch.full((N,), -1, dtype=torch.int32, device=dev))
    assoc_xyz = _scatter_rows(N, mm, rows_ok, last_lm_xyz,
                              torch.zeros((N, 3), device=dev))
    n_mm = torch.sum(rows_ok.to(torch.int32))
    obs1 = PointObs(xyz_w=assoc_xyz, uv=cur.feat.xy, inv_sigma2=inv_sig2,
                    mask=assoc_gid != -1, ur=cur.u_right)
    # The first solve only SEEDS stage 2, so it runs the short schedule.
    res1 = pose_optimize(T_pred, cam, obs1, rounds=2, iters=4)
    assoc_gid = torch.where(res1.inlier_pt, assoc_gid, -1)

    # ---- stage 2: local map ----
    lm_mt, lm_visible, _ = local_map_match(
        cam, scales, res1.Tcw, cur, win, assoc_gid != -1,
        scale_factor, n_levels, th_local,
    )
    lrows_ok = lm_mt >= 0
    assoc_gid2 = _scatter_rows(N, lm_mt, lrows_ok,
                               torch.where(lrows_ok, win.ids, -1), assoc_gid)
    assoc_xyz2 = _scatter_rows(N, lm_mt, lrows_ok, win.xyz, assoc_xyz)
    obs2 = PointObs(xyz_w=assoc_xyz2, uv=cur.feat.xy, inv_sigma2=inv_sig2,
                    mask=assoc_gid2 != -1, ur=cur.u_right)
    res2 = pose_optimize(res1.Tcw, cam, obs2, rounds=gn_rounds, iters=gn_iters)

    inlier = res2.inlier_pt & (assoc_gid2 != -1)
    lm_gid = torch.where(inlier & (assoc_gid2 >= 0), assoc_gid2, -1)
    found_local = lrows_ok & res2.inlier_pt[lm_mt.clamp(min=0).long()]
    return TrackResult(
        Tcw=res2.Tcw,
        lm_gid=lm_gid,
        inlier=inlier,
        n_mm_matches=n_mm,
        n_inliers=torch.sum(inlier.to(torch.int32)),
        visible_ids=torch.where(lm_visible, win.ids, -1),
        found_ids=torch.where(found_local, win.ids, -1),
        ll_gid=ll_gid,
        ln_inlier=ln_inlier,
        n_ln_inliers=n_ln,
    )


def bow_free_refkf_match(cam: Camera, cur: FrameData, kf_desc, kf_angle,
                         kf_valid, kf_lm_gid, kf_lm_xyz, T_init) -> TrackResult:
    """TrackReferenceKeyFrame fallback (reference Tracking.cc:1570-1614):
    global descriptor match against the reference keyframe (mutual NN +
    ratio + rotation consistency), then a pose optimization."""
    ll_gid, ln_inlier, n_ln = _no_lines(cur)
    N = cur.feat.capacity
    dev = T_init.device
    row_ok = kf_valid & (kf_lm_gid >= 0)
    dist = M.hamming(kf_desc, cur.feat.desc)
    dist = M.masked_distances(dist, row_ok, cur.feat.valid)
    mt, md = M.nn_match(dist, max_dist=M.TH_LOW, ratio=0.7, mutual=True)
    mt = M.rotation_consistency(kf_angle, cur.feat.angle, mt)
    mt = _resolve_columns(mt, md, N)
    rows_ok = mt >= 0
    assoc_gid = _scatter_rows(
        N, mt, rows_ok, torch.where(rows_ok, kf_lm_gid, -1),
        torch.full((N,), -1, dtype=torch.int32, device=dev))
    assoc_xyz = _scatter_rows(N, mt, rows_ok, kf_lm_xyz,
                              torch.zeros((N, 3), device=dev))
    obs = PointObs(xyz_w=assoc_xyz, uv=cur.feat.xy,
                   inv_sigma2=1.0 / cur.feat.sigma2, mask=assoc_gid >= 0,
                   ur=cur.u_right)
    res = pose_optimize(T_init, cam, obs)
    inlier = res.inlier_pt & (assoc_gid >= 0)
    e = torch.full((1,), -1, dtype=torch.int32, device=dev)
    return TrackResult(
        Tcw=res.Tcw,
        lm_gid=torch.where(inlier, assoc_gid, -1),
        inlier=inlier,
        n_mm_matches=torch.sum(rows_ok.to(torch.int32)),
        n_inliers=torch.sum(inlier.to(torch.int32)),
        visible_ids=e,
        found_ids=e,
        ll_gid=ll_gid,
        ln_inlier=ln_inlier,
        n_ln_inliers=n_ln,
    )
