"""The tracking pipeline (port of splslam_tpu/slam/pipeline.py, stereo,
monocular and RGB-D): frame build -> covisibility top-k -> local window
dedupe (points, and map lines with a line table) -> tracking step ->
landmark stat updates -> packed stats vector; plus keyframe insertion
with stereo landmark creation. In localization mode the previous frame's
depth adds temporal points that anchor the pose but never enter the map.

`vo_frame_step*` take one frame a call; `vo_batch_step` /
`vo_batch_step_mono` take B, as the reference's batch programs do: each
frame is built in turn (one ORB kernel launch a frame), the local point
and line windows are assembled once from the map and tracker state at
batch entry and stay frozen for the batch, the map-line counters move
frame by frame and the point counters once at the batch's end. A
single frame is a batch of one. All state stays on the device; the
host reads one packed stats row a frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.ops.topk import stable_top as _stable_top
from splslam_tpu_torch.slam import map as mapmod
from splslam_tpu_torch.slam.frame import (LINE_CFG, FrameData, build_frame_mono,
                                          build_frame_rgbd, build_frame_stereo)
from splslam_tpu_torch.slam.map import MapState
from splslam_tpu_torch.slam.tracking import LineWindow, LocalWindow, track_step
from splslam_tpu_torch.trace import span

# packed stats layout (the reference's)
S_POSE = slice(0, 16)
S_N_MM = 16
S_N_IN = 17
S_CLOSE_TRACKED = 18
S_CLOSE_UNTRACKED = 19
S_N_DEPTH = 20
S_REF_MATCHES = 21
S_N_LN_IN = 22
S_REF_LN_MATCHES = 23
STATS_LEN = 24


class StepState(NamedTuple):
    """Tracker state carried frame to frame, resident on the device."""

    frame: FrameData
    lm_gid: torch.Tensor    # [N] int32
    lm_xyz: torch.Tensor    # [N,3]
    Tcw: torch.Tensor       # (4,4)
    velocity: torch.Tensor  # (4,4) Tcw_i @ inv(Tcw_{i-1})
    ll_gid: torch.Tensor    # [L] int32 map-line id per line feature (-1)
    ll_xyz3: torch.Tensor   # [L,3,3]
    ll_len: torch.Tensor    # [L]

    @staticmethod
    def fresh(frame: FrameData, Tcw: torch.Tensor) -> "StepState":
        n = frame.feat.capacity
        l = frame.lines.capacity
        dev = Tcw.device
        return StepState(
            frame=frame,
            lm_gid=torch.full((n,), -1, dtype=torch.int32, device=dev),
            lm_xyz=torch.zeros((n, 3), device=dev),
            Tcw=Tcw,
            velocity=torch.eye(4, device=dev),
            ll_gid=torch.full((l,), -1, dtype=torch.int32, device=dev),
            ll_xyz3=torch.zeros((l, 3, 3), device=dev),
            ll_len=torch.zeros((l,), device=dev),
        )


def assemble_local_window(st: MapState, last_lm_gid: torch.Tensor,
                          m_local: int, k_top: int = 10) -> LocalWindow:
    """UpdateLocalMap (reference Tracking.cc:2595): keyframes ranked by
    shared-landmark count with the last frame; their landmark ids
    deduplicated into a fixed M-slot window."""
    cov = mapmod.covisibility_counts(st, last_lm_gid)
    k_top = min(k_top, cov.shape[0])
    top_cov, top_kf = _stable_top(cov, k_top, largest=True)
    ids = _dedupe_window(top_cov, st.kfs.lm_idx[top_kf], m_local)
    safe = ids.clamp(min=0).long()
    pts = st.pts
    return LocalWindow(
        ids=ids,
        xyz=pts.xyz[safe],
        desc=pts.desc[safe],
        normal=pts.normal[safe],
        dmin=pts.dmin[safe],
        dmax=pts.dmax[safe],
        ok=(ids >= 0) & pts.valid[safe],
    )


def _dedupe_window(top_cov, rows, q: int):
    """The ids of `rows` [k, n] (zeroed where top_cov == 0), deduplicated
    into q ascending slots, -1 padded."""
    rows = torch.where((top_cov > 0)[:, None], rows, -1)
    s = torch.sort(rows.reshape(-1)).values
    F = s.shape[0]
    first = torch.cat([s[:1] >= 0, (s[1:] != s[:-1]) & (s[1:] >= 0)])
    key = torch.where(first, torch.arange(F, dtype=torch.int32, device=s.device), F)
    sel, _ = _stable_top(key, min(q, F), largest=False)
    ids = torch.where(sel < F, s[sel.clamp(0, F - 1).long()], -1)
    if ids.shape[0] < q:
        ids = torch.cat([ids, ids.new_full((q - ids.shape[0],), -1)])
    return ids


def assemble_line_window(st: MapState, last_ll_gid: torch.Tensor,
                         last_lm_gid_for_lines: torch.Tensor, q_local: int,
                         k_top: int = 10) -> LineWindow:
    """UpdateLocalMapLines (reference Tracking.cc:2012-2022): keyframes
    ranked by shared map-line count with the last frame, plus a quarter of
    the point covisibility while fewer than 16 lines are shared
    (MapLineRenewing, Tracking.cc:2112-2179); their line ids deduplicated
    into a fixed Q-slot window."""
    member = mapmod.landmark_membership(last_ll_gid, st.lns.xyz.shape[0])
    kf_ll = st.kfs.ll_idx
    hit = member[kf_ll.clamp(min=0).long()] & (kf_ll >= 0)
    cov = torch.sum(hit.to(torch.int32), dim=1, dtype=torch.int32) \
        * st.kfs.valid.to(torch.int32)
    pt_cov = mapmod.covisibility_counts(st, last_lm_gid_for_lines)
    cov = cov + torch.where(torch.sum(cov) < 16, pt_cov // 4, 0)
    k_top = min(k_top, cov.shape[0])
    top_cov, top_kf = _stable_top(cov, k_top, largest=True)
    ids = _dedupe_window(top_cov, st.kfs.ll_idx[top_kf], q_local)
    safe = ids.clamp(min=0).long()
    lns = st.lns
    return LineWindow(ids=ids, xyz=lns.xyz[safe], desc=lns.desc[safe],
                      avg_len=lns.avg_len2d[safe],
                      ok=(ids >= 0) & lns.valid[safe])


def _temporal_points(prev: StepState, cam: Camera):
    """Localization-mode temporal VO points (reference UpdateLastFrame,
    src/Tracking.cc:1707): the previous frame's depth unprojected to world
    xyz for valid features without a landmark, gid -2 (a pose-only
    anchor). Returns (last_gid, last_xyz)."""
    f = prev.frame
    synth = (f.depth > 0) & (prev.lm_gid == -1) & f.feat.valid
    Twc = torch.linalg.inv_ex(prev.Tcw).inverse   # inv_ex: no host sync
    zp = torch.clamp(f.depth, min=1e-6)
    xc = (f.feat.xy[:, 0] - cam.cx) / cam.fx * zp
    yc = (f.feat.xy[:, 1] - cam.cy) / cam.fy * zp
    pw = torch.stack([xc, yc, zp], -1) @ Twc[:3, :3].T + Twc[:3, 3]
    return (torch.where(synth, -2, prev.lm_gid),
            torch.where(synth[:, None], pw, prev.lm_xyz))


@span("track.window")
def _windows(map_state: MapState, prev: StepState, m_local: int, lcap: int):
    """The local point window and (with a line table, capacity > 1) the
    line window from the map and the tracker state `prev`; the point
    window follows the map landmarks only."""
    win = assemble_local_window(map_state, prev.lm_gid, m_local)
    lwin = (assemble_line_window(map_state, prev.ll_gid, prev.lm_gid,
                                 min(1024, 4 * lcap)) if lcap > 1 else None)
    return win, lwin


def _track_body(frame: FrameData, map_state: MapState, prev: StepState,
                th_depth_m: float, ref_kf: int, cam: Camera, scales,
                m_local: int, scale_factor: float, n_levels: int,
                loc_mode: bool = False, win: LocalWindow | None = None,
                lwin: LineWindow | None = None):
    """Track one built frame against the map (and update the map-line
    counters); with `loc_mode`, also against the previous frame's temporal
    points. `win` / `lwin`: windows frozen by the caller (a batch), else
    assembled here from `map_state` and `prev`. Returns (map_state,
    new_step_state, stats [STATS_LEN], visible_ids, found_ids)."""
    T_pred = prev.velocity @ prev.Tcw
    last_gid, last_xyz = (_temporal_points(prev, cam) if loc_mode
                          else (prev.lm_gid, prev.lm_xyz))
    lcap = frame.lines.capacity
    if win is None:
        win, lwin = _windows(map_state, prev, m_local, lcap)
    f = prev.frame.feat
    line_kw = {}
    if lcap > 1:
        line_kw = dict(
            last_lines=prev.frame.lines, last_ll_gid=prev.ll_gid,
            last_ll_xyz3=prev.ll_xyz3, last_ll_len=prev.ll_len, lwin=lwin)
    res = track_step(
        cam, scales, frame, f.octave, f.angle, f.desc,
        last_xyz, last_gid, T_pred, win, **line_kw,
        scale_factor=scale_factor, n_levels=n_levels,
    )
    if lcap > 1:
        map_state = mapmod.update_line_stats(
            map_state, torch.where(lwin.ok, lwin.ids, -1), res.ll_gid,
            frame.lines.length)
    close = (frame.depth > 0) & (frame.depth < th_depth_m)
    n_close_tracked = torch.sum((close & res.inlier).to(torch.int32))
    n_close_untracked = torch.sum((close & ~res.inlier).to(torch.int32))
    n_depth = torch.sum((frame.depth > 0).to(torch.int32))

    # Reference-KF tracked map points with >= minObs observations
    # (reference KeyFrame::TrackedMapPoints, src/Tracking.cc:2206).
    min_obs = torch.where(map_state.n_kfs <= 2, 2, 3)
    ref_row = map_state.kfs.lm_idx[ref_kf]
    ref_safe = ref_row.clamp(min=0).long()
    ref_tracked = ((ref_row >= 0) & map_state.pts.valid[ref_safe]
                   & (map_state.pts.n_obs[ref_safe] >= min_obs))
    n_ref_matches = torch.sum(ref_tracked.to(torch.int32))
    ref_ll = map_state.kfs.ll_idx[ref_kf]
    ref_lsafe = ref_ll.clamp(min=0).long()
    n_ref_ln = torch.sum(((ref_ll >= 0) & map_state.lns.valid[ref_lsafe]
                          & (map_state.lns.n_obs[ref_lsafe] >= min_obs))
                         .to(torch.int32))

    stats = torch.cat([
        res.Tcw.reshape(-1),
        torch.stack([t.float() for t in (
            res.n_mm_matches, res.n_inliers, n_close_tracked,
            n_close_untracked, n_depth, n_ref_matches, res.n_ln_inliers,
            n_ref_ln)]),
    ])
    velocity = res.Tcw @ torch.linalg.inv_ex(prev.Tcw).inverse   # inv_ex: no host sync
    lsafe = res.ll_gid.clamp(min=0).long()
    new_state = StepState(
        frame=frame,
        lm_gid=res.lm_gid,
        lm_xyz=map_state.pts.xyz[res.lm_gid.clamp(min=0).long()],
        Tcw=res.Tcw,
        velocity=velocity,
        ll_gid=res.ll_gid,
        ll_xyz3=map_state.lns.xyz[lsafe],
        ll_len=map_state.lns.avg_len2d[lsafe],
    )
    return map_state, new_state, stats, res.visible_ids, res.found_ids


def track_frames_batch(
    frames: list[FrameData],
    map_state: MapState,
    prev: StepState,
    th_depth_m: float,
    ref_kf: int,
    cam: Camera,
    scales: torch.Tensor,
    m_local: int = 2048,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    loc_mode: bool = False,
) -> tuple[MapState, StepState, torch.Tensor]:
    """Track built frames in order against the map (reference
    track_frames_batch). The local point and line windows are assembled
    once, from the map and `prev` at entry: the map does not change
    inside a batch (keyframe insertion and mapping run between batches)
    apart from the counters. The map-line counters move frame by frame;
    the point counters once at the end, over every frame's visible and
    found ids (integer adds, in place). Returns (map, last step state,
    stats [B, STATS_LEN])."""
    win, lwin = _windows(map_state, prev, m_local, frames[0].lines.capacity)
    state, rows, vis, found = prev, [], [], []
    for frame in frames:
        map_state, state, stats, v, f = _track_body(
            frame, map_state, state, th_depth_m, ref_kf, cam, scales,
            m_local, scale_factor, n_levels, loc_mode, win=win, lwin=lwin)
        rows.append(stats)
        vis.append(v)
        found.append(f)
    map_state = mapmod.update_point_stats2(map_state, torch.cat(vis),
                                           torch.cat(found))
    return map_state, state, torch.stack(rows)


def build_frames_batch(imgs: torch.Tensor, cam: Camera, spec: PyramidSpec,
                       scales: torch.Tensor, line_capacity: int = 1,
                       line_cfg: tuple = LINE_CFG) -> list[FrameData]:
    """Stereo frames from uint8 pairs [B,2,H,W], built one after another
    (one ORB kernel launch a frame), as the reference's scan builds them."""
    return [build_frame_stereo(pair[0].float(), pair[1].float(), cam, spec,
                               scales, line_capacity, line_cfg)
            for pair in imgs]


def build_frames_batch_mono(imgs: torch.Tensor, cam: Camera, spec: PyramidSpec,
                            line_capacity: int = 128, undistort: bool = False,
                            line_cfg: tuple = LINE_CFG) -> list[FrameData]:
    """Monocular frames from uint8 images [B,H,W], built one after another
    (one ORB kernel launch a frame); lines when `line_capacity` > 1."""
    return [build_frame_mono(im.float(), cam, spec, undistort=undistort,
                             with_lines=line_capacity > 1,
                             line_capacity=line_capacity, line_cfg=line_cfg)
            for im in imgs]


def vo_batch_step(
    imgs: torch.Tensor,
    map_state: MapState,
    prev: StepState,
    th_depth_m: float,
    ref_kf: int,
    cam: Camera,
    spec: PyramidSpec,
    scales: torch.Tensor,
    m_local: int = 2048,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    line_capacity: int = 1,
    line_cfg: tuple = LINE_CFG,
    loc_mode: bool = False,
) -> tuple[MapState, StepState, torch.Tensor]:
    """B stereo frames (`imgs` uint8 [B,2,H,W] on the map's device): build,
    then track with the windows frozen at batch entry. Keyframe decisions
    run between batches on the host. Returns (map, new_step_state, stats
    [B, STATS_LEN])."""
    frames = build_frames_batch(imgs, cam, spec, scales, line_capacity, line_cfg)
    return track_frames_batch(frames, map_state, prev, th_depth_m, ref_kf, cam,
                              scales, m_local, scale_factor, n_levels, loc_mode)


def vo_batch_step_mono(
    imgs: torch.Tensor,
    map_state: MapState,
    prev: StepState,
    th_depth_m: float,
    ref_kf: int,
    cam: Camera,
    spec: PyramidSpec,
    scales: torch.Tensor,
    m_local: int = 2048,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    line_capacity: int = 128,
    undistort: bool = False,
    line_cfg: tuple = LINE_CFG,
    loc_mode: bool = False,
) -> tuple[MapState, StepState, torch.Tensor]:
    """B monocular frames (`imgs` uint8 [B,H,W]), after the map's
    initialization: as `vo_batch_step`."""
    frames = build_frames_batch_mono(imgs, cam, spec, line_capacity, undistort,
                                     line_cfg)
    return track_frames_batch(frames, map_state, prev, th_depth_m, ref_kf, cam,
                              scales, m_local, scale_factor, n_levels, loc_mode)


def vo_frame_step(
    imgs: torch.Tensor,
    map_state: MapState,
    prev: StepState,
    th_depth_m: float,
    ref_kf: int,
    cam: Camera,
    spec: PyramidSpec,
    scales: torch.Tensor,
    m_local: int = 2048,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    line_capacity: int = 8,
    line_cfg: tuple = LINE_CFG,
    loc_mode: bool = False,
) -> tuple[MapState, StepState, torch.Tensor]:
    """One stereo frame (`imgs` uint8 [2,H,W]): build, track, update the
    landmark counters in place. Returns (map, new_step_state, stats)."""
    frame = build_frame_stereo(imgs[0].float(), imgs[1].float(), cam, spec,
                               scales, line_capacity, line_cfg)
    return _track_one(frame, map_state, prev, th_depth_m, ref_kf, cam,
                      scales, m_local, scale_factor, n_levels, loc_mode)


def _track_one(frame, *args):
    """A batch of one frame; its stats row."""
    map_state, state, stats = track_frames_batch([frame], *args)
    return map_state, state, stats[0]


def vo_frame_step_rgbd(
    image: torch.Tensor,
    depth_map: torch.Tensor,
    map_state: MapState,
    prev: StepState,
    th_depth_m: float,
    ref_kf: int,
    cam: Camera,
    spec: PyramidSpec,
    scales: torch.Tensor,
    m_local: int = 2048,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    depth_factor: float = 1.0,
    line_capacity: int = 8,
    line_cfg: tuple = LINE_CFG,
    loc_mode: bool = False,
) -> tuple[MapState, StepState, torch.Tensor]:
    """One RGB-D frame (`image` [H,W], `depth_map` [H,W] f32 in the
    sensor's units; reference GrabImageRGBD -> Track, src/Tracking.cc:
    327-358): build, track, update the landmark counters in place.
    Returns (map, new_step_state, stats)."""
    frame = build_frame_rgbd(image.float(), depth_map.float(), cam, spec,
                             depth_factor, line_capacity, line_cfg)
    return _track_one(frame, map_state, prev, th_depth_m, ref_kf, cam,
                      scales, m_local, scale_factor, n_levels, loc_mode)


def vo_frame_step_mono(
    image: torch.Tensor,
    map_state: MapState,
    prev: StepState,
    th_depth_m: float,
    ref_kf: int,
    cam: Camera,
    spec: PyramidSpec,
    scales: torch.Tensor,
    m_local: int = 2048,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    with_lines: bool = False,
    line_capacity: int = 128,
    undistort: bool = False,
    line_cfg: tuple = LINE_CFG,
    loc_mode: bool = False,
) -> tuple[MapState, StepState, torch.Tensor]:
    """One monocular frame (`image` [H,W], reference GrabImageMonocular ->
    Track / TrackBoth, src/Tracking.cc:360-417): build, track, update the
    landmark counters in place. Returns (map, new_step_state, stats)."""
    frame = build_frame_mono(image.float(), cam, spec, undistort=undistort,
                             with_lines=with_lines, line_capacity=line_capacity,
                             line_cfg=line_cfg)
    return _track_one(frame, map_state, prev, th_depth_m, ref_kf, cam,
                      scales, m_local, scale_factor, n_levels, loc_mode)


def add_keyframe_step(
    map_state: MapState,
    state: StepState,
    frame_id: int,
    ts: float,
    depth_limit: float,
    cam: Camera,
    scale_factor: float = 1.2,
    n_levels: int = 8,
    max_new: int = 200,
    is_stereo: bool = True,
) -> tuple[MapState, StepState, torch.Tensor]:
    """Keyframe insertion + stereo landmark creation (reference
    CreateNewKeyFrame, src/Tracking.cc:2337-2416), in place on the map; a
    monocular keyframe creates no landmarks (local mapping triangulates
    them). Returns (map, state with updated associations, [kf_idx,
    n_matches, n_pts] f32)."""
    frame = state.frame
    map_state, kf = mapmod.insert_keyframe(
        map_state, frame, state.Tcw, state.lm_gid, state.ll_gid, frame_id, ts)
    lm_gid = state.lm_gid
    if is_stereo:
        map_state, lm_gid = mapmod.create_stereo_points(
            map_state, kf, frame, state.Tcw, lm_gid,
            cam.fx, cam.fy, cam.cx, cam.cy, depth_limit,
            scale_factor, n_levels, max_new=max_new,
        )
    out = torch.stack([t.float() for t in (
        kf, torch.sum((lm_gid >= 0).to(torch.int32)), map_state.n_pts)])
    new_state = state._replace(
        lm_gid=lm_gid,
        lm_xyz=map_state.pts.xyz[lm_gid.clamp(min=0).long()],
    )
    return map_state, new_state, out
