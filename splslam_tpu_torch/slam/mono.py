"""Monocular tracking path: two-view bootstrap + per-frame tracking (port
of splslam_tpu/slam/mono.py, one frame at a time; reference
src/Tracking.cc:360-417 GrabImageMonocular -> Track / TrackBoth).

- `MonocularInitialization(Both)` (src/Tracking.cc:1010-1377): hold a
  reference frame, match level-0 ORB features and line midpoints
  (`match_for_initialization`, `match_lines_for_initialization`), run the
  unified two-view RANSAC (`slam/initializer.py`), and on success build
  the initial map (`create_initial_map`, CreateInitialMapMonocularBoth
  :1379: two keyframes, landmarks and map lines from the triangulated
  inliers, the two-camera init BA, median-depth normalization).
- After init every frame runs `pipeline.vo_frame_step_mono`.

The RANSAC hypotheses come from `draw_init_samples`, the one place the
path draws random numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from splslam_tpu_torch import trace as T
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops import match as M
from splslam_tpu_torch.optim.ba import BAProblem, ba_solve, ba_solve_arbitrated
from splslam_tpu_torch.optim.pose_gn import line_coefficients
from splslam_tpu_torch.slam import map as mapmod
from splslam_tpu_torch.slam import pipeline
from splslam_tpu_torch.slam.frame import FrameData, build_frame_mono
from splslam_tpu_torch.slam.initializer import dlt_points, gumbel_samples, two_view_init
from splslam_tpu_torch.slam.map import MapState, scale_band
from splslam_tpu_torch.slam.mapping_ops import _set_rows
from splslam_tpu_torch.slam.pipeline import StepState

N_HYP = 256   # RANSAC hypotheses of the two-view init


def match_for_initialization(f1: FrameData, f2: FrameData):
    """Level-0 windowed match (reference ORBmatcher::SearchForInitialization):
    100 px window, ratio 0.9, mutual NN, rotation-histogram consistency.
    Returns (m12 [N] column in f2 or -1, count)."""
    lvl1 = f1.feat.octave == 0
    lvl2 = f2.feat.octave == 0
    win = M.window_mask(f1.feat.xy, f2.feat.xy, 100.0)
    d = M.masked_distances(M.hamming(f1.feat.desc, f2.feat.desc),
                           f1.feat.valid & lvl1, f2.feat.valid & lvl2, win)
    mt, _ = M.nn_match(d, max_dist=M.TH_LOW, ratio=0.9, mutual=True)
    mt = M.rotation_consistency(f1.feat.angle, f2.feat.angle, mt)
    return mt, torch.sum((mt >= 0).to(torch.int32))


def match_lines_for_initialization(f1: FrameData, f2: FrameData):
    """Line-midpoint init matching (reference Linematcher::
    SearchForInitialization, src/Linematcher.cc:146-286): midpoint window,
    LBD Hamming, relative length gate, rotation histogram on the line
    angle. Returns (m12L [L] or -1, count)."""
    l1, l2 = f1.lines, f2.lines
    win = M.window_mask(l1.midpoint, l2.midpoint, 100.0)
    rel = torch.abs(l2.length[None, :] - l1.length[:, None]) / torch.clamp(
        l1.length[:, None], min=1e-6)
    d = M.masked_distances(M.hamming(l1.desc, l2.desc), l1.valid, l2.valid,
                           win & (rel < 0.35))
    mt, _ = M.nn_match(d, max_dist=M.TH_HIGH, ratio=0.9, mutual=True)
    mt = M.rotation_consistency_lines(l1.angle, l2.angle, mt)
    return mt, torch.sum((mt >= 0).to(torch.int32))


def _scatter_drop(n: int, cols: torch.Tensor, ok: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """[n] int32 of -1 with out[cols[r]] = values[r] where ok (columns
    unique among those rows)."""
    buf = torch.full((n + 1,), -1, dtype=torch.int32, device=cols.device)
    buf[torch.where(ok, cols, n).long()] = values.to(torch.int32)
    return buf[:n]


def create_initial_map(
    st: MapState,
    f1: FrameData,
    f2: FrameData,
    m12: torch.Tensor,       # [N] f1-feature -> f2-feature match
    R21: torch.Tensor,
    t21: torch.Tensor,
    xyz_c1: torch.Tensor,    # [N,3] triangulated per f1 feature (cam-1 frame)
    good: torch.Tensor,      # [N] bool
    m12L: torch.Tensor,      # [Lc] f1-line -> f2-line match
    lmid_c1: torch.Tensor,   # [Lc,3] triangulated line midpoints (cam-1)
    lgood: torch.Tensor,     # [Lc] bool
    ts1: float,
    ts2: float,
    frame_id1: int,
    frame_id2: int,
    cam: Camera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
) -> tuple[MapState, StepState, torch.Tensor]:
    """KF0 (identity) + KF1 ([R21|t21] / median depth) and the initial
    landmarks and map lines (reference CreateInitialMapMonocularBoth,
    src/Tracking.cc:1379: line endpoints triangulated with the recovered
    pose, the median depth over both modalities), then the two-camera
    init BA (GlobalBundleAdjustemntIni, src/Optimizer.cc:4339), with line
    edges and point/line arbitration when the frames carry lines. The map
    (fresh) is written in place; slots past a table's capacity are
    dropped. Returns (map, tracker state for frame 2, [n_pts, med_depth,
    chi2, pose 16])."""
    dev = xyz_c1.device
    N = f1.feat.capacity
    Lc = f1.lines.capacity

    # median depth over points and line midpoints
    z = torch.cat([xyz_c1[:, 2], lmid_c1[:, 2]])
    both_good = torch.cat([good, lgood])
    zs = torch.sort(torch.where(both_good, z, float("inf"))).values
    n_good = torch.sum(both_good.to(torch.int32))
    med = zs.index_select(0, torch.clamp(n_good // 2, 0, N + Lc - 1).reshape(1))[0]
    inv_med = 1.0 / torch.clamp(med, min=1e-6)
    xyz_n = xyz_c1 * inv_med
    T1 = torch.eye(4, device=dev)
    T2 = torch.eye(4, device=dev)
    T2[:3, :3] = R21
    T2[:3, 3] = t21 * inv_med

    # landmark slots per good f1 feature
    slot = torch.cumsum(good.to(torch.int32), 0, dtype=torch.int32) - 1
    cap = st.pts.xyz.shape[0]
    create = good & (slot < cap)
    sl = torch.where(create, slot, cap)
    # normals and scale bands from the second view
    O2 = -R21.T @ (t21 * inv_med)
    view = xyz_n - O2
    dist2 = torch.sqrt(torch.sum(view * view, dim=-1))
    normal = view / torch.clamp(dist2[:, None], min=1e-9)
    m12s = m12.clamp(min=0).long()
    dmin, dmax = scale_band(dist2, f2.feat.octave[m12s], scale_factor, n_levels)
    pts = st.pts
    for table, val in ((pts.xyz, xyz_n), (pts.desc, f2.feat.desc[m12s]),
                       (pts.normal, normal), (pts.dmin, dmin), (pts.dmax, dmax),
                       (pts.n_obs, 2), (pts.n_visible, 2), (pts.n_found, 2),
                       (pts.first_kf, 0), (pts.valid, True)):
        _set_rows(table, sl, val)
    st = st._replace(n_pts=torch.sum(create.to(torch.int32)))
    lm1 = torch.where(create, slot, -1)
    lm2 = _scatter_drop(N, m12, create, slot)

    # map lines: endpoint triangulation with the recovered pose
    # (reference TriangulateLine, Initializer.cc:1763)
    Km = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                       [0.0, 0.0, 1.0]]).to(dev, non_blocking=True)
    P1 = Km @ T1[:3, :4]
    P2 = Km @ T2[:3, :4]
    m12Ls = m12L.clamp(min=0).long()
    seg1 = f1.lines.seg
    seg2m = f2.lines.seg[m12Ls]
    Xs = dlt_points(P1, P2, seg1[:, :2], seg2m[:, :2])
    Xe = dlt_points(P1, P2, seg1[:, 2:4], seg2m[:, 2:4])
    Xm = lmid_c1 * inv_med
    ep_ok = (torch.all(torch.isfinite(Xs), -1) & torch.all(torch.isfinite(Xe), -1)
             & (Xs[:, 2] > 1e-3) & (Xe[:, 2] > 1e-3))
    lcreate = lgood & ep_ok
    lslot = torch.cumsum(lcreate.to(torch.int32), 0, dtype=torch.int32) - 1
    lcap = st.lns.xyz.shape[0]
    lcreate = lcreate & (lslot < lcap)
    lsl = torch.where(lcreate, lslot, lcap)
    avg_len = 0.5 * (f1.lines.length + f2.lines.length[m12Ls])
    lns = st.lns
    for table, val in ((lns.xyz, torch.stack([Xs, Xm, Xe], dim=1)),
                       (lns.desc, f2.lines.desc[m12Ls]), (lns.avg_len2d, avg_len),
                       (lns.n_obs, 2), (lns.n_visible, 2), (lns.n_found, 2),
                       (lns.first_kf, 0), (lns.valid, True)):
        _set_rows(table, lsl, val)
    st = st._replace(n_lns=torch.sum(lcreate.to(torch.int32)))
    ll1 = torch.where(lcreate, lslot, -1)
    ll2 = _scatter_drop(Lc, m12L, lcreate, lslot)

    st, _ = mapmod.insert_keyframe(st, f1, T1, lm1, ll1, frame_id1, ts1)
    st, _ = mapmod.insert_keyframe(st, f2, T2, lm2, ll2, frame_id2, ts2)

    # init BA: 2 cameras (cam0 frozen), all landmarks
    L = cap
    e_cam = torch.cat([torch.zeros((N,), dtype=torch.int32, device=dev),
                       torch.ones((N,), dtype=torch.int32, device=dev)])
    lm_rows = torch.cat([lm1, lm2])
    e_sig = torch.cat([1.0 / f1.feat.sigma2, 1.0 / f2.feat.sigma2])
    e_ok = lm_rows >= 0
    prob = BAProblem(
        Tcw=torch.stack([T1, T2]),
        cam_free=torch.tensor([False, True]).to(dev, non_blocking=True),
        xyz=st.pts.xyz, lm_ok=st.pts.valid, e_cam=e_cam,
        e_lm=lm_rows.clamp(min=0), e_uv=torch.cat([f1.feat.xy, f2.feat.xy]),
        e_ur=torch.full((2 * N,), -1.0, device=dev), e_inv_sigma2=e_sig,
        e_ok=e_ok)
    if Lc > 1:
        # Line endpoints ride as landmark slots after the point table; an
        # observation is an edge pair sharing the observed 2D line.
        lcap_t = st.lns.xyz.shape[0]
        Ep = 2 * N
        rows = torch.arange(Lc, dtype=torch.int32, device=dev)

        def line_edges(ll, seg, cam_id, e0):
            coefs = line_coefficients(seg)
            sl_s = L + 2 * ll.clamp(min=0)
            base = e0 + rows * 2
            return (torch.full((2 * Lc,), cam_id, dtype=torch.int32, device=dev),
                    torch.stack([sl_s, sl_s + 1], 1).reshape(-1),
                    torch.stack([coefs, coefs], 1).reshape(-1, 3),
                    torch.repeat_interleave(ll >= 0, 2),
                    torch.stack([base + 1, base], 1).reshape(-1))

        c1, l1_, co1, o1, p1_ = line_edges(ll1, f1.lines.seg, 0, Ep)
        c2, l2_, co2, o2, p2_ = line_edges(ll2, f2.lines.seg, 1, Ep + 2 * Lc)
        El = 4 * Lc
        prob = prob._replace(
            xyz=torch.cat([st.pts.xyz, st.lns.xyz[:, (0, 2), :].reshape(-1, 3)]),
            lm_ok=torch.cat([st.pts.valid, torch.repeat_interleave(st.lns.valid, 2)]),
            e_cam=torch.cat([e_cam, c1, c2]),
            e_lm=torch.cat([prob.e_lm, l1_, l2_]),
            e_uv=torch.cat([prob.e_uv, torch.zeros((El, 2), device=dev)]),
            e_ur=torch.full((Ep + El,), -1.0, device=dev),
            e_inv_sigma2=torch.cat([e_sig, torch.full((El,), 0.25, device=dev)]),
            e_ok=torch.cat([e_ok, o1, o2]),
            e_coef=torch.cat([torch.zeros((Ep, 3), device=dev), co1, co2]),
            e_line=torch.cat([torch.zeros((Ep,), dtype=torch.bool, device=dev),
                              torch.ones((El,), dtype=torch.bool, device=dev)]),
            e_pair=torch.cat([torch.full((Ep,), -1, dtype=torch.int32, device=dev),
                              p1_, p2_]),
        )
        res = ba_solve_arbitrated(cam, prob, rounds=2, iters=8, n_free=2)
        ends = res.xyz[L:L + 2 * lcap_t].reshape(lcap_t, 2, 3)
        xyz3_opt = torch.stack([ends[:, 0], 0.5 * (ends[:, 0] + ends[:, 1]),
                                ends[:, 1]], 1)
        lns.xyz.copy_(torch.where(lns.valid[:, None, None], xyz3_opt, lns.xyz))
    else:
        res = ba_solve(cam, prob, rounds=2, iters=8, n_free=2)
    T2_opt = res.Tcw[1]
    st.pts.xyz.copy_(res.xyz[:L])
    st.kfs.Tcw[1] = T2_opt
    # drop the second view's landmarks whose edges became outliers
    bad2 = (prob.e_ok & ~res.e_inlier)[N:2 * N]
    lm2_f = torch.where(bad2, -1, lm2)
    st.kfs.lm_idx[1] = lm2_f

    lsafe = ll2.clamp(min=0).long()
    step = StepState.fresh(f2, T2_opt)._replace(
        lm_gid=lm2_f,
        lm_xyz=st.pts.xyz[lm2_f.clamp(min=0).long()],
        ll_gid=ll2,
        ll_xyz3=st.lns.xyz[lsafe],
        ll_len=st.lns.avg_len2d[lsafe],
    )
    stats = torch.stack([st.n_pts.to(torch.float32), med, res.total_chi2])
    return st, step, torch.cat([stats, T2_opt.reshape(-1)])


def draw_init_samples(mask: torch.Tensor, n_hyp: int = N_HYP) -> torch.Tensor:
    """The two-view RANSAC hypotheses [n_hyp, 8]: Gumbel top-k draws from
    a generator seeded 0 on every attempt, as the reference seeds its key
    (DUtils::Random::SeedRandOnce(0), Initializer.cc:186)."""
    gen = torch.Generator(device=mask.device)
    gen.manual_seed(0)
    return gumbel_samples(mask, n_hyp, gen)


class _MonoInit(NamedTuple):
    frame: FrameData
    ts: float
    frame_id: int


def track_mono_impl(system, image: torch.Tensor, ts: float) -> np.ndarray:
    """One monocular frame of `system` (the state machine of the
    reference's MonocularInitialization(Both) and Track)."""
    from splslam_tpu_torch.slam.system import TrackingState

    s = system
    st = s.settings
    if s.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
        frame = build_frame_mono(image.float(), s.cam, s.spec,
                                 undistort=st.has_distortion,
                                 with_lines=st.using_line,
                                 line_capacity=s.line_cap, line_cfg=s.line_cfg)
        use_lines = st.using_line
        n_feat = int(T.read(torch.sum(frame.feat.valid)))
        n_line = int(T.read(torch.sum(frame.lines.valid)))
        # line gates OR'd with the point gates (reference
        # MonocularInitializationBoth, src/Tracking.cc:1164, :1214), scaled
        # to this detector's capacity
        enough_feat = n_feat > 100 or (use_lines and n_line > 16)
        if s.mono_state is None:
            if enough_feat:
                s.mono_state = _MonoInit(frame, ts, s.frame_id)
                s.state = TrackingState.NOT_INITIALIZED
            s.frame_id += 1
            return s.last_Tcw_np.copy()
        if not enough_feat:
            s.mono_state = None
            s.state = TrackingState.NO_IMAGES_YET
            s.frame_id += 1
            return s.last_Tcw_np.copy()

        ref = s.mono_state
        m12, n_m = match_for_initialization(ref.frame, frame)
        Lc = frame.lines.capacity
        dev = s.device
        if use_lines:
            m12L, n_ml = match_lines_for_initialization(ref.frame, frame)
            n_ml = int(T.read(n_ml))
        else:
            m12L = torch.full((Lc,), -1, dtype=torch.int32, device=dev)
            n_ml = 0
        if int(T.read(n_m)) < 70 and not (use_lines and n_ml >= 14):
            # too few matches: this frame becomes the new reference
            s.mono_state = _MonoInit(frame, ts, s.frame_id)
            s.frame_id += 1
            return s.last_Tcw_np.copy()

        # unified correspondences: points, then line midpoints
        ok_p = m12 >= 0
        ok_l = m12L >= 0
        xy1 = torch.cat([ref.frame.feat.xy, ref.frame.lines.midpoint])
        xy2 = torch.cat([frame.feat.xy[m12.clamp(min=0).long()],
                         frame.lines.midpoint[m12L.clamp(min=0).long()]])
        ok = torch.cat([ok_p, ok_l])
        K = torch.tensor([[s.cam.fx, 0.0, s.cam.cx], [0.0, s.cam.fy, s.cam.cy],
                          [0.0, 0.0, 1.0]]).to(dev)
        N = ref.frame.feat.capacity
        # line midpoints are noisier than corners: a 3 px sigma band
        inv_s2 = torch.cat([torch.ones((N,), device=dev),
                            torch.full((Lc,), 1.0 / 9.0, device=dev)])
        res = two_view_init(draw_init_samples(ok), xy1, xy2, ok, K,
                            inv_sigma2=inv_s2)
        ok, used_h = T.read(torch.cat([res.ok.reshape(1), res.used_h.reshape(1)]))
        if not ok:
            s.frame_id += 1
            return s.last_Tcw_np.copy()
        s.init_used_h = bool(used_h)
        s.map, s.step, out = create_initial_map(
            s.map, ref.frame, frame, m12, res.R21, res.t21,
            res.xyz[:N], res.good[:N] & ok_p, m12L, res.xyz[N:],
            res.good[N:] & ok_l, ref.ts, ts, ref.frame_id, s.frame_id, s.cam,
            scale_factor=st.scale_factor, n_levels=st.n_levels)
        out = T.read(out)
        s.n_kfs = 2
        s.n_pts = int(out[0])
        s.ref_kf = 1
        s.frames_since_kf = 0
        T2 = out[3:].reshape(4, 4).astype(np.float32)
        s.kf_pose_host[0] = np.eye(4, dtype=np.float32)
        s.kf_pose_host[1] = T2
        s.state = TrackingState.OK
        s.last_Tcw_np = T2
        s._log_frame(ref.ts, np.eye(4, dtype=np.float32), lost=False)
        s._log_frame(ts, T2, lost=False)
        s._register_kf_bow(0, ref.frame)
        s._register_kf_bow(1, frame)
        s.mono_state = None
        s.frame_id += 1
        s.mapper.big_change_idx += 1
        return T2.copy()

    s.map, new_step, stats = pipeline.vo_frame_step_mono(
        image, s.map, s.step, s.th_depth_m, s.ref_kf, s.cam, s.spec, s.scales,
        m_local=st.local_window, scale_factor=st.scale_factor,
        n_levels=st.n_levels, with_lines=st.using_line,
        line_capacity=s.line_cap, undistort=st.has_distortion,
        line_cfg=s.line_cfg, loc_mode=s.localization_only)
    return s._enqueue_step(new_step, stats, ts)
