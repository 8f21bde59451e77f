"""Local mapping on the device: point and line culling, triangulation,
fuse, local BA and keyframe culling (port of
splslam_tpu/slam/mapping_ops.py).

One call of `mapping_step` per keyframe runs the reference LocalMapping
thread's stages as batched tensor passes (RunBoth's point and line
stages one after the other, `with_lines`):
  1. MapPointCulling (src/LocalMapping.cc:408) and MapLineCulling
     (:446): the 3-strike probation.
  2. CreateNewMapPoints (:484) and CreateNewMapLines (:731): epipolar-
     gated descriptor matching against the best covisible neighbours and
     DLT triangulation (a line: its midpoint and both endpoints).
  3. SearchInNeighbors fuse (:1249, lines :1331): project this keyframe's
     landmarks (line midpoints) into the neighbours and merge duplicates
     by an index remap.
  4. Local BA (src/Optimizer.cc:2383) over the covisibility window with
     fixed 2-ring anchors, map lines as endpoint pairs under the dual
     point/line arbitration; outlier observations are erased afterwards.
  5. KeyFrameCulling (:1577), with lines KeyFrameCullingBoth.

The tables are updated IN PLACE (the reference returns new immutable
states); a caller must treat the state it passed in as consumed.

Scatter rules. Where the reference's scatter-set can receive one index
from several rows, XLA's CPU scatter keeps the last write; the port
makes that explicit and device-independent: the highest row index wins
(`_last_writer`), on the CPU and on CUDA alike (`index_put_` on CUDA
makes no promise). Rows that write nothing go to a spare slot past the
table's end (`_set_rows`), never to -1.

Nothing here reads a value back to the host: a neighbour's rows are
gathered with a 1-element index tensor (a 0-dim one is read back), and
constants go into tables with `index_fill_` (a Python scalar written
through an index tensor waits for the device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops import match as M
from splslam_tpu_torch.ops.match import popcount32
from splslam_tpu_torch.ops.linalg import smallest_singular_vector
from splslam_tpu_torch.optim.ba import BAProblem, _inv3, ba_solve, ba_solve_arbitrated
from splslam_tpu_torch.optim.pose_gn import line_coefficients
from splslam_tpu_torch.slam.map import (KeyFrames, MapState, covisibility_counts,
                                        predict_octave, scale_band)
from splslam_tpu_torch.slam.pipeline import _stable_top
from splslam_tpu_torch.trace import span

# Static window geometry (capacities, not behaviour), as the reference's.
N_WINDOW = 8      # free cameras in local BA (1-ring cap)
N_FIXED = 8       # fixed anchor cameras (2-ring cap)
N_NEIGH = 4       # neighbours for triangulation / fuse
L_WINDOW = 8192   # landmark slots in the BA window
LN_WINDOW = 512   # map-line slots in the BA window (two endpoints each)
MAX_TRI = 256     # new landmarks per (keyframe, neighbour) pair
MAX_TRI_LINES = 64  # new map lines per (keyframe, neighbour) pair

# mapping_step stats vector layout (read by slam/local_mapping.py):
# [0:4]   n_pts, n_edges, n_inlier_edges, total_chi2
# [4:20]  post-BA Tcw of the stepped keyframe (row-major 4x4)
# then MAX_KF_CULL blocks of 17: [culled_id (-1 none), Tcp row-major 4x4]
# then the three solver-health counters of optim/ba.BAResult.
MAX_KF_CULL = 2
MSTAT_POSE = 4
MSTAT_CULL = 20
MSTAT_GUARD = MSTAT_CULL + MAX_KF_CULL * 17
MSTAT_REVERT = MSTAT_GUARD + 1
MSTAT_LMSING = MSTAT_REVERT + 1
MSTAT_LEN = MSTAT_LMSING + 1

_N_LV = 8  # octave histogram width of keyframe culling (the reference's)


def _last_writer(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """For each target slot in [0, size): the highest row r with ok[r] and
    idx[r] == slot, else -1 (the last write of a sequential scatter)."""
    rows = torch.arange(idx.numel(), device=idx.device)
    w = torch.full((size + 1,), -1, dtype=torch.long, device=idx.device)
    w.scatter_reduce_(0, torch.where(ok, idx, size).reshape(-1).long(), rows,
                      "amax")
    return w[:size]


def _scatter_set_last(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """dst (1-D) with dst[idx[r]] = values[r] for rows with ok; where rows
    share an index the highest row wins. Returns a new tensor."""
    w = _last_writer(idx, ok, dst.shape[0])
    return torch.where(w >= 0, values[w.clamp(min=0)].to(dst.dtype), dst)


def _set_rows(table: torch.Tensor, idx: torch.Tensor, values) -> None:
    """In place: table[idx[r]] = values[r] (a tensor, or one constant for
    every row); idx == len(table) marks a row that writes nothing (it
    lands in a spare slot that is dropped). The kept indices must be
    unique."""
    cap = table.shape[0]
    buf = torch.cat([table, table[:1]])
    if torch.is_tensor(values):
        buf[idx.long()] = values.to(table.dtype)
    else:
        buf.index_fill_(0, idx.long(), values)
    table.copy_(buf[:cap])


def _neighbor(neighbors: torch.Tensor, j: int):
    """(id [] int32, -1 for none; row index [1] int64, clamped to 0) of
    neighbour j."""
    return neighbors[j], neighbors[j:j + 1].clamp(min=0).long()


def _center(T: torch.Tensor) -> torch.Tensor:
    return -T[:3, :3].T @ T[:3, 3]


def _intrinsics(cam: Camera, device):
    """(K, K^-1), both inverted on the host in float32 and sent without
    waiting for the device queue (a plain host-to-device copy would
    synchronize the stream)."""
    K = torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy],
                      [0.0, 0.0, 1.0]], dtype=torch.float32)
    return (K.to(device, non_blocking=True),
            torch.linalg.inv(K).to(device, non_blocking=True))


def _topk_covisible(st: MapState, kf: int, k: int):
    """Top-k other keyframes by shared-landmark count with keyframe `kf`
    (reference KeyFrame::GetBestCovisibilityKeyFrames), ties to the lower
    index. Returns (ids [k] int32, -1 below the reference's weight 15,
    counts [k])."""
    counts = covisibility_counts(st, st.kfs.lm_idx[kf])
    counts = torch.where(torch.arange(counts.shape[0], device=counts.device) == kf,
                         0, counts)
    k = min(k, counts.shape[0])
    top_c, top_i = _stable_top(counts, k, largest=True)
    ids = torch.where(top_c >= 15, top_i.to(torch.int32), -1)
    return ids, top_c


def cull_points(st: MapState, cur_kf: int, th_obs: int = 3) -> MapState:
    """MapPointCulling (reference src/LocalMapping.cc:408-444) on the
    tables: a landmark born at keyframe b is culled while on probation
    (recent, age <= 3) if found/visible < 0.25 (with >= 4 visible), or at
    age >= 2 with n_obs <= th_obs. Observations of culled landmarks are
    dropped from every keyframe row."""
    pts = st.pts
    ratio = pts.n_found.float() / torch.clamp(pts.n_visible.float(), min=1.0)
    age = cur_kf - pts.first_kf
    probation = pts.recent & (age <= 3)
    bad_ratio = probation & (ratio < 0.25) & (pts.n_visible >= 4)
    bad_obs = (age >= 2) & probation & (pts.n_obs <= th_obs)
    cull = pts.valid & (bad_ratio | bad_obs)
    pts.valid.copy_(pts.valid & ~cull)
    pts.recent.copy_(pts.recent & (age <= 3))
    lm_idx = st.kfs.lm_idx
    live = pts.valid[lm_idx.clamp(min=0).long()] & (lm_idx >= 0)
    lm_idx.copy_(torch.where(live, lm_idx, -1))
    return st


def _epipolar_from_poses(Tcw1, Tcw2, cam: Camera):
    """Fundamental matrix F12 mapping image-1 points to image-2 lines
    (reference LocalMapping::ComputeF12)."""
    R1, t1 = Tcw1[:3, :3], Tcw1[:3, 3]
    R2, t2 = Tcw2[:3, :3], Tcw2[:3, 3]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    z = torch.zeros((), device=Tcw1.device)
    tx = torch.stack([torch.stack([z, -t12[2], t12[1]]),
                      torch.stack([t12[2], z, -t12[0]]),
                      torch.stack([-t12[1], t12[0], z])])
    _, Kinv = _intrinsics(cam, Tcw1.device)
    return Kinv.T @ tx @ R12 @ Kinv


class _TriOut(NamedTuple):
    xyz: torch.Tensor      # [N,3] triangulated world points (kf feature rows)
    ok: torch.Tensor       # [N] bool
    nb_col: torch.Tensor   # [N] matched neighbour feature index, -1 none
    quality: torch.Tensor  # [N] 1 - cos(parallax), -1 where not ok


def _triangulate_pair(st: MapState, cam: Camera, scales: torch.Tensor, kf: int,
                      nb: torch.Tensor, nb_valid: torch.Tensor) -> _TriOut:
    """Match the unassociated features of `kf` against those of neighbour
    `nb` under the epipolar constraint (mutual nearest neighbour, TH_LOW),
    then DLT-triangulate and check depth, parallax, reprojection and scale
    (reference CreateNewMapPoints, src/LocalMapping.cc:484-729). `nb`: the
    neighbour's row, a 1-element index."""
    kfs = st.kfs
    T1, T2 = kfs.Tcw[kf], kfs.Tcw[nb][0]
    F12 = _epipolar_from_poses(T1, T2, cam)
    xy1, xy2 = kfs.xy[kf], kfs.xy[nb][0]
    free1 = kfs.fvalid[kf] & (kfs.lm_idx[kf] < 0)
    free2 = kfs.fvalid[nb][0] & (kfs.lm_idx[nb][0] < 0) & nb_valid

    # Baseline longer than the stereo baseline (reference :529-545),
    # bf / fx divided in float32 as the reference's f32 scalars are.
    O1, O2 = _center(T1), _center(T2)
    stereo_baseline = float(np.float32(cam.bf) / np.float32(cam.fx))
    base_ok = torch.linalg.norm(O2 - O1) > stereo_baseline

    x1h = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=-1)
    lines = x1h @ F12.T
    num = (lines[:, None, 0] * xy2[None, :, 0] + lines[:, None, 1] * xy2[None, :, 1]
           + lines[:, None, 2])
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    dsq = num * num / torch.clamp(den, min=1e-12)
    sig2_2 = kfs.sigma2[nb][0]
    epi_ok = dsq < 3.84 * sig2_2[None, :]

    d = M.masked_distances(M.hamming(kfs.desc[kf], kfs.desc[nb][0]), free1, free2,
                           epi_ok)
    mt, _ = M.nn_match(d, max_dist=M.TH_LOW, mutual=True)
    matched = (mt >= 0) & base_ok
    col = mt.clamp(min=0).long()
    uv2 = xy2[col]

    # Inhomogeneous DLT: w = 1, least squares over the 4 equations via
    # the 3x3 normal equations (reference :594-611 uses an SVD).
    K, _ = _intrinsics(cam, T1.device)
    P1 = K @ T1[:3, :4]
    P2 = K @ T2[:3, :4]
    A_rows = torch.stack([xy1[:, 0, None] * P1[2] - P1[0],
                          xy1[:, 1, None] * P1[2] - P1[1],
                          uv2[:, 0, None] * P2[2] - P2[0],
                          uv2[:, 1, None] * P2[2] - P2[1]], dim=1)   # [N,4,4]
    Ah = A_rows[:, :, :3]
    bh = -A_rows[:, :, 3]
    AtA = torch.sum(Ah[:, :, :, None] * Ah[:, :, None, :], dim=1)
    Atb = torch.sum(Ah * bh[:, :, None], dim=1)
    Xw = torch.sum(_inv3(AtA) * Atb[:, None, :], dim=-1)

    # Checks (reference :613-727).
    pc1 = Xw @ T1[:3, :3].T + T1[:3, 3]
    pc2 = Xw @ T2[:3, :3].T + T2[:3, 3]
    z_ok = (pc1[:, 2] > 1e-3) & (pc2[:, 2] > 1e-3)
    r1, r2 = Xw - O1, Xw - O2
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-9)
    par_ok = cosp < 0.9998

    def reproj_chi2(pc, uv, sig2):
        zs = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        return ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / sig2

    rep_ok = ((reproj_chi2(pc1, xy1, kfs.sigma2[kf]) <= 5.991)
              & (reproj_chi2(pc2, uv2, sig2_2[col]) <= 5.991))
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    ratio_d = d1 / torch.clamp(d2, min=1e-9)
    ratio_o = scales[kfs.octave[kf].long()] / scales[kfs.octave[nb][0].long()][col]
    scale_ok = (ratio_d < ratio_o * 1.5) & (ratio_d > ratio_o / 1.5)

    ok = matched & z_ok & par_ok & rep_ok & scale_ok
    return _TriOut(xyz=Xw, ok=ok, nb_col=torch.where(ok, mt, -1),
                   quality=torch.where(ok, 1.0 - cosp, -1.0))


def _alloc_points(st: MapState, scale_factor: float, n_levels: int, kf: int,
                  nb: torch.Tensor, tri: _TriOut, max_new: int) -> MapState:
    """Append the triangulated landmarks (at most `max_new`, largest
    parallax first) to the point table and register the observation in
    both keyframe rows."""
    kfs = st.kfs
    n = tri.ok.shape[0]
    dev = tri.ok.device
    create = tri.ok
    order_key = torch.where(create, -tri.quality, 1e30)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[torch.argsort(order_key, stable=True)] = torch.arange(
        n, dtype=torch.int32, device=dev)
    create = create & (rank < max_new)
    slot_off = torch.cumsum(create.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = st.n_pts + slot_off
    cap = st.pts.xyz.shape[0]
    create = create & (slots < cap)
    n_new = torch.sum(create.to(torch.int32), dtype=torch.int32)
    sl = torch.where(create, slots, cap)

    O1 = _center(kfs.Tcw[kf])
    view = tri.xyz - O1
    dist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp(dist[:, None], min=1e-9)
    dmin, dmax = scale_band(dist, kfs.octave[kf], scale_factor, n_levels)
    # Stereo features count 2 per observation (MapPoint::AddObservation).
    nb_col = tri.nb_col.clamp(min=0).long()
    obs_w = (torch.where(kfs.u_right[kf] >= 0, 2, 1)
             + torch.where(kfs.u_right[nb][0][nb_col] >= 0, 2, 1))

    pts = st.pts
    for table, val in ((pts.xyz, tri.xyz), (pts.desc, kfs.desc[kf]),
                       (pts.normal, normal), (pts.dmin, dmin), (pts.dmax, dmax),
                       (pts.n_obs, obs_w), (pts.n_visible, 1), (pts.n_found, 1),
                       (pts.first_kf, kf), (pts.valid, True), (pts.recent, True)):
        _set_rows(table, sl, val)
    lm_kf = torch.where(create, slots, kfs.lm_idx[kf])
    # Mutual matching gives created rows distinct columns; the others
    # write -1, which max leaves alone.
    nb_row = kfs.lm_idx[nb][0]
    nb_row.scatter_reduce_(0, nb_col, torch.where(create, slots, -1), "amax")
    kfs.lm_idx[kf] = lm_kf
    kfs.lm_idx[nb] = nb_row[None]
    return st._replace(n_pts=st.n_pts + n_new)


def create_new_points(st: MapState, cam: Camera, scales: torch.Tensor, kf: int,
                      neighbors: torch.Tensor, scale_factor: float,
                      n_levels: int) -> MapState:
    """CreateNewMapPoints against the top covisible neighbours."""
    for j in range(neighbors.shape[0]):
        nb_id, nb = _neighbor(neighbors, j)
        nb_valid = (nb_id >= 0).expand(st.kfs.fvalid.shape[1])
        tri = _triangulate_pair(st, cam, scales, kf, nb, nb_valid)
        tri = tri._replace(ok=tri.ok & (nb_id >= 0) & (nb_id != kf))
        st = _alloc_points(st, scale_factor, n_levels, kf, nb, tri, MAX_TRI)
    return st


def fuse_neighbors(st: MapState, cam: Camera, scales: torch.Tensor, kf: int,
                   neighbors: torch.Tensor, scale_factor: float,
                   n_levels: int) -> MapState:
    """SearchInNeighbors (reference src/LocalMapping.cc:1249-1329 +
    ORBmatcher::Fuse): project `kf`'s landmarks into each neighbour; a hit
    on a feature that has a landmark merges the two (the one with more
    observations survives, MapPoint::Replace), a hit on a free feature
    adds the observation. The nearest-neighbour match is not mutual, so
    two rows can pick one target: the highest row wins, as in the
    reference's scatter."""
    P = st.pts.xyz.shape[0]
    dev = st.pts.xyz.device
    remap = torch.arange(P, dtype=torch.int32, device=dev)
    kfs, pts = st.kfs, st.pts

    for j in range(neighbors.shape[0]):
        nb_id, nb = _neighbor(neighbors, j)
        nb_ok = (nb_id >= 0) & (nb_id != kf)
        lm = kfs.lm_idx[kf].clone()
        li = lm.clamp(min=0).long()
        lm_ok = (lm >= 0) & pts.valid[li] & nb_ok
        xyz = pts.xyz[li]
        T2 = kfs.Tcw[nb][0]
        pc = xyz @ T2[:3, :3].T + T2[:3, 3]
        zs = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        uv = torch.stack([u, v], dim=-1)
        inimg = ((u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
                 & (pc[:, 2] > 1e-3))
        O2 = _center(T2)
        dist3 = torch.linalg.norm(xyz - O2, dim=-1)
        band_ok = (dist3 > 0.8 * pts.dmin[li]) & (dist3 < 1.2 * pts.dmax[li])
        viewcos = torch.sum((xyz - O2) * pts.normal[li], dim=-1) / torch.clamp(
            dist3, min=1e-9)
        rows_ok = lm_ok & inimg & band_ok & (viewcos > 0.5)

        pred = predict_octave(dist3, pts.dmax[li], scale_factor, n_levels)
        radius = 3.0 * scales[pred.long()]
        wmask = M.window_mask(uv, kfs.xy[nb][0], radius)
        omask = M.octave_mask(pred, kfs.octave[nb][0], -1, 1)
        dmat = M.masked_distances(M.hamming(pts.desc[li], kfs.desc[nb][0]), rows_ok,
                                  kfs.fvalid[nb][0], wmask & omask)
        mt, _ = M.nn_match(dmat, max_dist=M.TH_LOW)
        hit = mt >= 0
        col = mt.clamp(min=0).long()
        nb_lm = kfs.lm_idx[nb][0]
        tgt_lm = nb_lm[col]

        # Case A: merge lm -> tgt (or tgt -> lm) where the target exists.
        both = hit & (tgt_lm >= 0) & (tgt_lm != lm)
        keep_tgt = pts.n_obs[tgt_lm.clamp(min=0).long()] >= pts.n_obs[li]
        winner = torch.where(keep_tgt, tgt_lm, lm)
        loser = torch.where(keep_tgt, lm, tgt_lm)
        remap = _scatter_set_last(remap, loser, both, winner)
        # Case B: a free feature gains the observation.
        free_hit = hit & (tgt_lm < 0)
        nb_row = _scatter_set_last(nb_lm, mt, free_hit, lm)
        w_new = torch.where(kfs.u_right[nb][0][col] >= 0, 2, 1).to(torch.int32)
        pts.n_obs.index_add_(0, li, torch.where(free_hit, w_new, 0))
        kfs.lm_idx[nb] = nb_row[None]

    # Resolve remap chains (losers pointing at losers) by two hops, then
    # apply to every observation row and invalidate the losers.
    remap = remap[remap.long()]
    remap = remap[remap.long()]
    merged = remap != torch.arange(P, dtype=torch.int32, device=dev)
    lm_idx = kfs.lm_idx
    lm_idx.copy_(torch.where(lm_idx >= 0, remap[lm_idx.clamp(min=0).long()], -1))
    gain = torch.zeros_like(pts.n_obs).index_add_(
        0, remap.long(), pts.n_obs * merged.to(torch.int32))
    pts.valid.copy_(pts.valid & ~merged)
    pts.n_obs.add_(gain)
    return st


def cull_lines(st: MapState, cur_kf: int, th_obs: int = 2) -> MapState:
    """MapLineCulling (reference src/LocalMapping.cc:446-482): the points'
    3-strike probation on the map-line table (every line younger than 4
    keyframes is on probation)."""
    lns = st.lns
    ratio = lns.n_found.float() / torch.clamp(lns.n_visible.float(), min=1.0)
    age = cur_kf - lns.first_kf
    probation = age <= 3
    bad_ratio = probation & (ratio < 0.25) & (lns.n_visible >= 4)
    bad_obs = (age >= 2) & probation & (lns.n_obs <= th_obs)
    lns.valid.copy_(lns.valid & ~(bad_ratio | bad_obs))
    ll_idx = st.kfs.ll_idx
    live = lns.valid[ll_idx.clamp(min=0).long()] & (ll_idx >= 0)
    ll_idx.copy_(torch.where(live, ll_idx, -1))
    return st


def _dlt_points(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor) -> torch.Tensor:
    """Homogeneous DLT triangulation of [M,2] pixel pairs under the
    projections P1, P2 [3,4] -> [M,3]: the nullspace of the 4x4 system
    (the reference's SVD; here the Jacobi form of `ops/linalg.py`, since a
    4x4 system of a line seen at little parallax can have its two
    smallest singular values close together), dehomogenised with |w|
    floored at 1e-12 as the reference does."""
    A = torch.stack([uv1[:, 0, None] * P1[2] - P1[0],
                     uv1[:, 1, None] * P1[2] - P1[1],
                     uv2[:, 0, None] * P2[2] - P2[0],
                     uv2[:, 1, None] * P2[2] - P2[1]], dim=1)    # [M,4,4]
    X = smallest_singular_vector(A)
    w = X[:, 3:]
    return X[:, :3] / torch.where(torch.abs(w) < 1e-12, 1e-12, w)


def _triangulate_lines_pair(st: MapState, cam: Camera, kf: int, nb: torch.Tensor,
                            nb_ok: torch.Tensor):
    """Match the free line features of `kf` against those of neighbour
    `nb` (a 1-element row index) by LBD under the midpoint epipolar and
    length-consistency gates (mutual nearest neighbour at TH_HIGH), then
    DLT-triangulate the midpoint and both endpoints and check depth,
    parallax and midpoint reprojection (reference CreateNewMapLines,
    src/LocalMapping.cc:731-984). Returns (xyz3 [Lf,3,3] start/mid/end,
    ok [Lf], matched column [Lf] (-1 where not ok), mean 2D length)."""
    kfs = st.kfs
    T1, T2 = kfs.Tcw[kf], kfs.Tcw[nb][0]
    F12 = _epipolar_from_poses(T1, T2, cam)
    seg1, seg2 = kfs.lseg[kf], kfs.lseg[nb][0]
    mid1 = 0.5 * (seg1[:, :2] + seg1[:, 2:4])
    mid2 = 0.5 * (seg2[:, :2] + seg2[:, 2:4])
    free1 = kfs.lvalid[kf] & (kfs.ll_idx[kf] < 0)
    free2 = kfs.lvalid[nb][0] & (kfs.ll_idx[nb][0] < 0) & nb_ok

    x1h = torch.cat([mid1, torch.ones_like(mid1[:, :1])], dim=-1)
    lines = x1h @ F12.T
    num = (lines[:, None, 0] * mid2[None, :, 0] + lines[:, None, 1] * mid2[None, :, 1]
           + lines[:, None, 2])
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    epi_ok = num * num / torch.clamp(den, min=1e-12) < 3.84
    len1, len2 = kfs.llen[kf], kfs.llen[nb][0]
    len_ok = (torch.abs(len1[:, None] - len2[None, :])
              / torch.clamp(torch.maximum(len1[:, None], len2[None, :]), min=1e-6)
              < 0.5)
    d = M.masked_distances(M.hamming(kfs.ldesc[kf], kfs.ldesc[nb][0]), free1, free2,
                           epi_ok & len_ok)
    # TH_HIGH: the reference's line matchers gate there (Linematcher.cc:39).
    mt, _ = M.nn_match(d, max_dist=M.TH_HIGH, mutual=True)
    col = mt.clamp(min=0).long()

    K, _ = _intrinsics(cam, T1.device)
    P1 = K @ T1[:3, :4]
    P2 = K @ T2[:3, :4]
    m2 = mid2[col]
    n = mid1.shape[0]
    X = _dlt_points(P1, P2, torch.cat([mid1, seg1[:, :2], seg1[:, 2:4]]),
                    torch.cat([m2, seg2[col, :2], seg2[col, 2:4]]))
    Xm, Xs, Xe = X[:n], X[n:2 * n], X[2 * n:]

    # Midpoint checks (the reference's 1-dof line gate, 3.841 per axis).
    pc1 = Xm @ T1[:3, :3].T + T1[:3, 3]
    pc2 = Xm @ T2[:3, :3].T + T2[:3, 3]
    z_ok = (pc1[:, 2] > 1e-3) & (pc2[:, 2] > 1e-3)
    r1, r2 = Xm - _center(T1), Xm - _center(T2)
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-9)
    par_ok = cosp < 0.9998

    def reproj_sq(pc, uv):
        zs = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    rep_ok = (reproj_sq(pc1, mid1) <= 3.841 * 2) & (reproj_sq(pc2, m2) <= 3.841 * 2)
    # Both endpoints in front of the first camera too.
    zs_ok = (((Xs @ T1[:3, :3].T + T1[:3, 3])[:, 2] > 1e-3)
             & ((Xe @ T1[:3, :3].T + T1[:3, 3])[:, 2] > 1e-3))
    finite = torch.all(torch.isfinite(X.reshape(3, n, 3)), dim=-1).all(dim=0)
    ok = (mt >= 0) & z_ok & par_ok & rep_ok & zs_ok & finite
    return (torch.stack([Xs, Xm, Xe], dim=1), ok, torch.where(ok, mt, -1),
            0.5 * (len1 + len2[col]))


def create_new_lines(st: MapState, cam: Camera, kf: int, neighbors: torch.Tensor,
                     max_new: int = MAX_TRI_LINES) -> MapState:
    """CreateNewMapLines against the top covisible neighbours: the first
    `max_new` triangulated lines of each pair (in feature order) get the
    next slots of the line table and an observation in both keyframe
    rows. Mutual matching gives them distinct columns in the
    neighbour's row."""
    Lf = st.kfs.lvalid.shape[1]
    cap = st.lns.xyz.shape[0]
    for j in range(neighbors.shape[0]):
        nb_id, nb = _neighbor(neighbors, j)
        nb_ok = ((nb_id >= 0) & (nb_id != kf)).expand(Lf)
        xyz3, ok, mt, avg_len = _triangulate_lines_pair(st, cam, kf, nb, nb_ok)
        kfs = st.kfs
        slot_off = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32) - 1
        slots = st.n_lns + slot_off
        create = ok & (slot_off < max_new) & (slots < cap)
        sl = torch.where(create, slots, cap)
        lns = st.lns
        for table, val in ((lns.xyz, xyz3), (lns.desc, kfs.ldesc[kf]),
                           (lns.avg_len2d, avg_len), (lns.n_obs, 2),
                           (lns.n_visible, 1), (lns.n_found, 1),
                           (lns.first_kf, kf), (lns.valid, True)):
            _set_rows(table, sl, val)
        ll_kf = torch.where(create, slots, kfs.ll_idx[kf])
        nb_row = kfs.ll_idx[nb][0]
        nb_row.scatter_reduce_(0, mt.clamp(min=0).long(),
                               torch.where(create, slots, -1), "amax")
        kfs.ll_idx[kf] = ll_kf
        kfs.ll_idx[nb] = nb_row[None]
        st = st._replace(n_lns=st.n_lns + torch.sum(create.to(torch.int32),
                                                    dtype=torch.int32))
    return st


def fuse_neighbor_lines(st: MapState, cam: Camera, kf: int,
                        neighbors: torch.Tensor) -> MapState:
    """SearchInNeighborsLines + Linematcher::Fuse (reference
    src/LocalMapping.cc:1331-1412, src/Linematcher.cc:881): project the
    midpoints of `kf`'s map lines into each neighbour; a hit on a line
    feature that has a map line merges the two (the one with more
    observations survives, MapLine::Replace), a hit on a free feature adds
    the observation. Gates: a 10 px midpoint window, the average 2D
    length within 35%, LBD at TH_LOW. The match is not mutual, so two
    rows can pick one target: the highest row wins, as in the
    reference's scatter."""
    Q = st.lns.xyz.shape[0]
    dev = st.lns.xyz.device
    remap = torch.arange(Q, dtype=torch.int32, device=dev)
    kfs, lns = st.kfs, st.lns

    for j in range(neighbors.shape[0]):
        nb_id, nb = _neighbor(neighbors, j)
        nb_ok = (nb_id >= 0) & (nb_id != kf)
        ll = kfs.ll_idx[kf].clone()
        qi = ll.clamp(min=0).long()
        ll_ok = (ll >= 0) & lns.valid[qi] & nb_ok
        T2 = kfs.Tcw[nb][0]
        pc = lns.xyz[qi, 1] @ T2[:3, :3].T + T2[:3, 3]
        zs = torch.clamp(pc[:, 2], min=1e-6)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        inimg = ((u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
                 & (pc[:, 2] > 1e-3))
        rows_ok = ll_ok & inimg

        seg2 = kfs.lseg[nb][0]
        wmask = M.window_mask(torch.stack([u, v], dim=-1),
                              0.5 * (seg2[:, :2] + seg2[:, 2:4]), 10.0)
        avg = lns.avg_len2d[qi][:, None]
        len_ok = torch.abs(kfs.llen[nb][0][None, :] - avg) / torch.clamp(avg, min=1e-6) \
            < 0.35
        dmat = M.masked_distances(M.hamming(lns.desc[qi], kfs.ldesc[nb][0]), rows_ok,
                                  kfs.lvalid[nb][0], wmask & len_ok)
        mt, _ = M.nn_match(dmat, max_dist=M.TH_LOW)
        hit = mt >= 0
        nb_ll = kfs.ll_idx[nb][0]
        tgt = nb_ll[mt.clamp(min=0).long()]

        # Case A: merge ll -> tgt (or tgt -> ll) where the target exists.
        both = hit & (tgt >= 0) & (tgt != ll)
        keep_tgt = lns.n_obs[tgt.clamp(min=0).long()] >= lns.n_obs[qi]
        winner = torch.where(keep_tgt, tgt, ll)
        loser = torch.where(keep_tgt, ll, tgt)
        remap = _scatter_set_last(remap, loser, both, winner)
        # Case B: a free feature gains the observation.
        free_hit = hit & (tgt < 0)
        nb_row = _scatter_set_last(nb_ll, mt, free_hit, ll)
        lns.n_obs.index_add_(0, qi, free_hit.to(torch.int32))
        kfs.ll_idx[nb] = nb_row[None]

    # Resolve remap chains by two hops, then apply to every observation
    # row and invalidate the losers.
    remap = remap[remap.long()]
    remap = remap[remap.long()]
    merged = remap != torch.arange(Q, dtype=torch.int32, device=dev)
    ll_idx = kfs.ll_idx
    ll_idx.copy_(torch.where(ll_idx >= 0, remap[ll_idx.clamp(min=0).long()], -1))
    gain = torch.zeros_like(lns.n_obs).index_add_(
        0, remap.long(), lns.n_obs * merged.to(torch.int32))
    lns.valid.copy_(lns.valid & ~merged)
    lns.n_obs.add_(gain)
    return st


def _window_lookup(lm_ids: torch.Tensor, P: int) -> torch.Tensor:
    """Landmark id -> window slot (-1 outside the window), [P+1]. The -1
    pads all write slot P, which no caller reads."""
    lookup = torch.full((P + 1,), -1, dtype=torch.int32, device=lm_ids.device)
    lookup[torch.where(lm_ids >= 0, lm_ids, P).long()] = torch.arange(
        lm_ids.shape[0], dtype=torch.int32, device=lm_ids.device)
    return lookup


def refresh_landmark_stats(st: MapState, cams: torch.Tensor, lm_ids: torch.Tensor,
                           scale_factor: float = 1.2, n_levels: int = 8) -> MapState:
    """ComputeDistinctiveDescriptors + UpdateNormalAndDepth for the BA
    window's landmarks (reference src/MapPoint.cc): gather each
    landmark's observations in the window keyframes, keep the descriptor
    with the least median Hamming distance to the others, and refresh the
    mean viewing direction and the scale band."""
    C = cams.shape[0]
    L = lm_ids.shape[0]
    P = st.pts.xyz.shape[0]
    kfs = st.kfs
    N = kfs.lm_idx.shape[1]
    dev = cams.device
    gk = cams.clamp(min=0).long()
    lm_rows = kfs.lm_idx[gk]                                   # [C,N]
    slot = _window_lookup(lm_ids, P)[lm_rows.clamp(0, P).long()]
    obs_ok = (cams >= 0)[:, None] & (lm_rows >= 0) & (slot >= 0) & kfs.fvalid[gk]

    # One observation per (landmark slot, camera). A keyframe row can hold
    # one landmark twice (after a fuse remap); the highest feature index
    # wins, as in the reference's scatter.
    ci = torch.arange(C, device=dev)[:, None].expand(C, N)
    cell = torch.where(obs_ok, slot, L).long() * C + ci
    w = _last_writer(cell, obs_ok, (L + 1) * C).reshape(L + 1, C)[:L]
    obs_has = w >= 0
    wi = w.clamp(min=0)
    obs_desc = torch.where(obs_has[..., None], kfs.desc[gk].reshape(C * N, 8)[wi], 0)
    obs_oct = torch.where(obs_has, kfs.octave[gk].reshape(-1)[wi], 0)

    # Min-median Hamming descriptor over the valid pairs only: invalid
    # pairs sort last, the median is read at (n - 1) // 2.
    x = obs_desc[:, :, None, :] ^ obs_desc[:, None, :, :]
    d = torch.sum(popcount32(x), dim=-1, dtype=torch.int32)       # [L,C,C]
    pair_ok = obs_has[:, :, None] & obs_has[:, None, :]
    d_sorted = torch.sort(torch.where(pair_ok, d, 1 << 15), dim=-1).values
    n_obs_w = torch.sum(obs_has.to(torch.int32), dim=-1, dtype=torch.int32)
    mi = torch.clamp(torch.div(n_obs_w - 1, 2, rounding_mode="floor"), 0, C - 1)
    med = torch.gather(d_sorted, 2, mi[:, None, None].long().expand(L, C, 1))[..., 0]
    med = torch.where(obs_has, med.float(), float("inf"))
    best = torch.argmin(med, dim=-1)
    ar = torch.arange(L, device=dev)
    new_desc = obs_desc[ar, best]

    # The reference's "centres" are -R t (its einsum contracts R^T over
    # the wrong index), not -R^T t; reproduced as is (ROADMAP queue C).
    T = kfs.Tcw[gk]
    O = -torch.einsum("cij,ci->cj", T[:, :3, :3].transpose(1, 2), T[:, :3, 3])
    xyz = st.pts.xyz[lm_ids.clamp(min=0).long()]
    rays = xyz[:, None, :] - O[None, :, :]
    rn = torch.linalg.norm(rays, dim=-1)
    unit = rays / torch.clamp(rn[..., None], min=1e-9)
    normal = torch.sum(torch.where(obs_has[..., None], unit, 0.0), dim=1) \
        / torch.clamp(n_obs_w[:, None].float(), min=1.0)
    dmin, dmax = scale_band(rn[ar, best], obs_oct[ar, best], scale_factor,
                            n_levels)

    tgt = torch.where((lm_ids >= 0) & (n_obs_w >= 2), lm_ids, P)
    pts = st.pts
    for table, val in ((pts.desc, new_desc), (pts.normal, normal),
                       (pts.dmin, dmin), (pts.dmax, dmax)):
        _set_rows(table, tgt, val)
    return st


def _redundancy(idx: torch.Tensor, ok: torch.Tensor, octave: torch.Tensor,
                n_lm: int):
    """Per keyframe row: (observations kept by `ok`, those whose landmark
    is seen by >= 4 keyframes, itself included, at an octave <= its own
    + 1), both [K] int32."""
    K, N = idx.shape
    oct_c = torch.clamp(octave, 0, _N_LV - 1)
    # cnt_leq[lm, o]: keyframes observing lm at an octave <= o.
    hist = torch.zeros(((n_lm + 1) * _N_LV,), dtype=torch.int32, device=idx.device)
    hist.index_add_(0, (torch.where(ok, idx, n_lm).long() * _N_LV + oct_c).reshape(-1),
                    torch.ones(K * N, dtype=torch.int32, device=idx.device))
    cnt_leq = torch.cumsum(hist.reshape(n_lm + 1, _N_LV)[:n_lm], dim=1,
                           dtype=torch.int32)
    gate_oct = torch.clamp(oct_c + 1, 0, _N_LV - 1)
    redundant = ok & (cnt_leq[idx.clamp(min=0).long(), gate_oct.long()] >= 4)
    return (torch.sum(ok.to(torch.int32), dim=1, dtype=torch.int32),
            torch.sum(redundant.to(torch.int32), dim=1, dtype=torch.int32))


def cull_keyframes(st: MapState, kf: int, with_lines: bool = False):
    """KeyFrameCulling (reference src/LocalMapping.cc:1577-1751): a
    keyframe >= 90% of whose landmarks are seen by at least 3 other
    keyframes at the same or a finer scale is marked bad (never keyframe
    0, `kf` or `kf - 1`; at most MAX_KF_CULL per call) and its
    observations are erased. With `with_lines` (KeyFrameCullingBoth) a
    keyframe must be redundant in its map lines too, by the same rule,
    unless it observes none. Returns (state, culled ids [MAX_KF_CULL]
    int32, -1 padded)."""
    kfs = st.kfs
    K = kfs.lm_idx.shape[0]
    P = st.pts.xyz.shape[0]
    dev = kfs.lm_idx.device
    lm = kfs.lm_idx.clone()
    ok = (lm >= 0) & kfs.fvalid & kfs.valid[:, None]
    n_feat, n_red = _redundancy(lm, ok, kfs.octave, P)
    ratio = n_red.float() / torch.clamp(n_feat.float(), min=1.0)

    idx = torch.arange(K, device=dev)
    cand = (kfs.valid & (idx != 0) & (idx != kf) & (idx != kf - 1)
            & (ratio > 0.9) & (n_feat > 50))
    if with_lines:
        ll = kfs.ll_idx
        lok = ((ll >= 0) & kfs.lvalid & kfs.valid[:, None]
               & st.lns.valid[ll.clamp(min=0).long()])
        n_lf, n_lred = _redundancy(ll, lok, kfs.loctave, st.lns.xyz.shape[0])
        lratio = n_lred.float() / torch.clamp(n_lf.float(), min=1.0)
        cand = cand & ((n_lf == 0) | (lratio > 0.9))
    order = torch.argsort(torch.where(cand, -ratio, float("inf")), stable=True)
    sel = order[:MAX_KF_CULL]
    culled_ids = torch.where(cand[sel], sel, -1).to(torch.int32)
    cull = torch.zeros((K,), dtype=torch.bool, device=dev)
    cull[sel] = cand[sel]
    kfs.valid.copy_(kfs.valid & ~cull)
    # Erase the culled keyframes' observations (reference SetBadFlag).
    gone = ok & cull[:, None]
    w = torch.where(kfs.u_right >= 0, 2, 1).to(torch.int32)
    st.pts.n_obs.index_add_(0, lm.clamp(min=0).reshape(-1).long(),
                            torch.where(gone, -w, 0).reshape(-1))
    kfs.lm_idx.copy_(torch.where(cull[:, None], -1, lm))
    if with_lines:
        # Every line observation of a culled keyframe counts, alive or
        # not (the reference tests ll >= 0 only).
        ll = kfs.ll_idx
        st.lns.n_obs.index_add_(0, ll.clamp(min=0).reshape(-1).long(),
                                torch.where((ll >= 0) & cull[:, None], -1, 0)
                                .to(torch.int32).reshape(-1))
        ll.copy_(torch.where(cull[:, None], -1, ll))
    return st, culled_ids


def _unique_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The distinct non-negative values of `ids` [F] in ascending order,
    the first min(n, F) of them, padded with -1: a fixed shape
    (`torch.unique`'s depends on the data and waits for the device)."""
    s = torch.sort(ids).values
    F = s.shape[0]
    first = torch.cat([s[:1] >= 0, (s[1:] != s[:-1]) & (s[1:] >= 0)])
    key = torch.where(first, torch.arange(F, dtype=torch.int32, device=ids.device), F)
    sel = torch.sort(key).values[:min(n, F)]
    return torch.where(sel < F, s[sel.clamp(0, F - 1).long()], -1)


def build_ba_window(st: MapState, kf: int):
    """Free cameras: `kf` and its best covisible keyframes (1-ring,
    reference Optimizer.cc:2386-2405); fixed: the next best (2-ring,
    :2442-2465). Landmarks: the union of the free cameras' observations,
    deduplicated, at most L_WINDOW. Returns (cams [C] int32 with -1 pads,
    lm_ids [L] int32 with -1 pads)."""
    ids, _ = _topk_covisible(st, kf, N_WINDOW + N_FIXED - 1)
    dev = ids.device
    free = torch.cat([torch.full((1,), kf, dtype=torch.int32, device=dev),
                      ids[:N_WINDOW - 1]])
    cams = torch.cat([free, ids[N_WINDOW - 1:]])
    rows = st.kfs.lm_idx[free.clamp(min=0).long()]
    flat = torch.where((free >= 0)[:, None], rows, -1).reshape(-1)
    ok = (flat >= 0) & st.pts.valid[flat.clamp(min=0).long()]
    return cams, _unique_ids(torch.where(ok, flat, -1), L_WINDOW)


def build_line_window(st: MapState, cams: torch.Tensor) -> torch.Tensor:
    """The BA window's map lines: the union of the free cameras' line
    observations, deduplicated, at most LN_WINDOW, -1 padded (reference
    Optimizer.cc:2466-2516)."""
    free = cams[:N_WINDOW]
    rows = st.kfs.ll_idx[free.clamp(min=0).long()]
    flat = torch.where((free >= 0)[:, None], rows, -1).reshape(-1)
    ok = (flat >= 0) & st.lns.valid[flat.clamp(min=0).long()]
    return _unique_ids(torch.where(ok, flat, -1), LN_WINDOW)


def make_ba_problem(st: MapState, cams: torch.Tensor,
                    lm_ids: torch.Tensor) -> BAProblem:
    """The fixed-shape edge table for `ba_solve`: each (camera slot,
    feature) pair whose landmark is in the window is one edge."""
    P = st.pts.xyz.shape[0]
    C = cams.shape[0]
    kfs = st.kfs
    N = kfs.lm_idx.shape[1]
    gk = cams.clamp(min=0).long()
    cam_ok = cams >= 0
    lm_rows = kfs.lm_idx[gk]
    slot = _window_lookup(lm_ids, P)[lm_rows.clamp(0, P).long()]
    e_ok = (cam_ok[:, None] & (lm_rows >= 0) & (slot >= 0) & kfs.fvalid[gk]
            & st.pts.valid[lm_rows.clamp(min=0).long()])
    e_cam = torch.arange(C, dtype=torch.int32, device=cams.device)[:, None] \
        .expand(C, N).reshape(-1)
    return BAProblem(
        Tcw=kfs.Tcw[gk],
        # Keyframe 0 stays frozen as the gauge anchor.
        cam_free=cam_ok & (cams != 0),
        xyz=st.pts.xyz[lm_ids.clamp(min=0).long()],
        lm_ok=lm_ids >= 0,
        e_cam=e_cam,
        e_lm=torch.where(e_ok, slot, 0).reshape(-1),
        e_uv=kfs.xy[gk].reshape(-1, 2),
        e_ur=torch.where(e_ok, kfs.u_right[gk], -1.0).reshape(-1),
        e_inv_sigma2=(1.0 / kfs.sigma2[gk]).reshape(-1),
        e_ok=e_ok.reshape(-1),
    )


def add_line_edges(st: MapState, cams: torch.Tensor, ln_ids: torch.Tensor,
                   prob: BAProblem) -> BAProblem:
    """Append the map lines `ln_ids` as endpoint vertices and their
    observations in the cameras `cams` as pairs of 1-dof edges to a point
    problem (reference LocalBundleAdjustmentmainOld's line blocks,
    src/Optimizer.cc:2630-2753). Landmark slots: [points L | line q's
    start at L+2q, its end at L+2q+1]. Edge rows: [point edges | for each
    (camera, line feature) the start edge, then the end edge], each
    pointing at its partner through e_pair; line rows carry the observed
    2D line and a 2 px sigma."""
    Q = st.lns.xyz.shape[0]
    L = prob.xyz.shape[0]
    C = cams.shape[0]
    kfs = st.kfs
    Lf = kfs.ll_idx.shape[1]
    dev = cams.device
    gk = cams.clamp(min=0).long()
    ll_rows = kfs.ll_idx[gk]                                     # [C,Lf]
    slot_q = _window_lookup(ln_ids, Q)[ll_rows.clamp(0, Q).long()]
    obs_ok = ((cams >= 0)[:, None] & (ll_rows >= 0) & (slot_q >= 0)
              & kfs.lvalid[gk] & st.lns.valid[ll_rows.clamp(min=0).long()])
    coef = line_coefficients(kfs.lseg[gk].reshape(-1, 4))          # [C*Lf,3]

    def inter(a, b):   # [E], [E] -> [2E] as a0, b0, a1, b1, ...
        return torch.stack([a, b], dim=1).reshape(-1)

    Ep = prob.e_cam.shape[0]
    El = 2 * C * Lf
    base = torch.arange(C * Lf, dtype=torch.int32, device=dev) * 2 + Ep
    sl_start = (L + 2 * torch.where(obs_ok, slot_q, 0)).reshape(-1)
    le_cam = torch.arange(C, dtype=torch.int32, device=dev)[:, None] \
        .expand(C, Lf).reshape(-1)
    flat_ok = obs_ok.reshape(-1)
    ends = st.lns.xyz[ln_ids.clamp(min=0).long()]
    return BAProblem(
        Tcw=prob.Tcw,
        cam_free=prob.cam_free,
        xyz=torch.cat([prob.xyz, torch.stack([ends[:, 0], ends[:, 2]], dim=1)
                       .reshape(-1, 3)]),
        lm_ok=torch.cat([prob.lm_ok, inter(ln_ids >= 0, ln_ids >= 0)]),
        e_cam=torch.cat([prob.e_cam, inter(le_cam, le_cam)]),
        e_lm=torch.cat([prob.e_lm, inter(sl_start, sl_start + 1)]),
        e_uv=torch.cat([prob.e_uv, torch.zeros((El, 2), device=dev)]),
        e_ur=torch.cat([prob.e_ur, torch.full((El,), -1.0, device=dev)]),
        e_inv_sigma2=torch.cat([prob.e_inv_sigma2,
                                torch.full((El,), 0.25, device=dev)]),
        e_ok=torch.cat([prob.e_ok, inter(flat_ok, flat_ok)]),
        e_coef=torch.cat([torch.zeros((Ep, 3), device=dev),
                          torch.stack([coef, coef], dim=1).reshape(-1, 3)]),
        e_line=torch.cat([torch.zeros((Ep,), dtype=torch.bool, device=dev),
                          torch.ones((El,), dtype=torch.bool, device=dev)]),
        e_pair=torch.cat([torch.full((Ep,), -1, dtype=torch.int32, device=dev),
                          inter(base + 1, base)]),
    )


def apply_ba_result(st: MapState, cams: torch.Tensor, lm_ids: torch.Tensor,
                    prob: BAProblem, res, ln_ids: torch.Tensor | None = None
                    ) -> MapState:
    """Write the optimized poses (free slots, never keyframe 0) and
    landmarks back, and erase the outlier observations (reference
    Optimizer.cc:2766-2830). With `ln_ids` (the problem holds line edges,
    `add_line_edges`), the map lines' optimized endpoints too, the
    midpoint re-derived as their mean, and the line observations whose
    endpoint pair failed the joint gate (:2832-2873)."""
    C = cams.shape[0]
    kfs = st.kfs
    N = kfs.lm_idx.shape[1]
    P = st.pts.xyz.shape[0]
    dev = cams.device
    gid = cams[:N_WINDOW]
    write = gid > 0
    tgt = torch.where(write, gid, 0).long()
    kfs.Tcw[tgt] = torch.where(write[:, None, None], res.Tcw[:N_WINDOW], kfs.Tcw[tgt])
    _set_rows(st.pts.xyz, torch.where(lm_ids >= 0, lm_ids, P),
              res.xyz[:lm_ids.shape[0]])

    Ep = C * N
    bad = (prob.e_ok[:Ep] & ~res.e_inlier[:Ep]).reshape(C, N)
    gk = cams.clamp(min=0).long()
    lm_rows = kfs.lm_idx[gk]
    new_rows = torch.where(bad, -1, lm_rows)
    # Pads (-1) clamp to keyframe 0 and rewrite its unchanged row; where
    # slots share a keyframe the highest slot's row wins, as in the
    # reference's scatter.
    ar = torch.arange(C, device=dev)
    win = torch.max(torch.where(gk[:, None] == gk[None, :], ar[None, :], -1),
                    dim=1).values
    kfs.lm_idx[gk] = new_rows[win]
    w_obs = torch.where(prob.e_ur[:Ep] >= 0, 2, 1).to(torch.int32).reshape(C, N)
    st.pts.n_obs.index_add_(0, lm_rows.clamp(min=0).reshape(-1).long(),
                            torch.where(bad, -w_obs, 0).reshape(-1))
    if ln_ids is None:
        return st
    lns = st.lns
    Q = lns.xyz.shape[0]
    L = lm_ids.shape[0]
    LN = ln_ids.shape[0]
    ends = res.xyz[L:L + 2 * LN].reshape(LN, 2, 3)
    _set_rows(lns.xyz, torch.where(ln_ids >= 0, ln_ids, Q),
              torch.stack([ends[:, 0], 0.5 * (ends[:, 0] + ends[:, 1]), ends[:, 1]],
                          dim=1))
    # Both rows of a pair share the joint verdict: read the start rows.
    Lf = kfs.ll_idx.shape[1]
    start = slice(Ep, Ep + 2 * C * Lf, 2)
    bad_l = (prob.e_ok[start] & ~res.e_inlier[start]).reshape(C, Lf)
    ll_rows = kfs.ll_idx[gk]
    kfs.ll_idx[gk] = torch.where(bad_l, -1, ll_rows)[win]
    lns.n_obs.index_add_(0, ll_rows.clamp(min=0).reshape(-1).long(),
                         torch.where(bad_l, -1, 0).to(torch.int32).reshape(-1))
    return st


@span("map.upkeep")
def map_upkeep(st: MapState, kf: int, cam: Camera, scales: torch.Tensor,
               scale_factor: float = 1.2, n_levels: int = 8, th_obs: int = 3,
               with_lines: bool = False):
    """Stages 1-3 of the mapping step: cull, triangulate against the
    covisible neighbours, fuse; each for points, then for lines with
    `with_lines`. Returns (state, neighbours)."""
    st = cull_points(st, kf, th_obs=th_obs)
    if with_lines:
        st = cull_lines(st, kf)
    neighbors, _ = _topk_covisible(st, kf, N_NEIGH)
    st = create_new_points(st, cam, scales, kf, neighbors, scale_factor, n_levels)
    if with_lines:
        st = create_new_lines(st, cam, kf, neighbors)
    st = fuse_neighbors(st, cam, scales, kf, neighbors, scale_factor, n_levels)
    if with_lines:
        st = fuse_neighbor_lines(st, cam, kf, neighbors)
    return st, neighbors


@span("map.local_ba")
def local_ba(st: MapState, kf: int, cam: Camera, scale_factor: float = 1.2,
             n_levels: int = 8, ba_rounds: int = 2, ba_iters: int = 5,
             with_lines: bool = False):
    """Stage 4: window, landmark upkeep, local BA and its write-back. With
    `with_lines` the window's map lines join as endpoint pairs and the
    dual point/line solve with pose arbitration runs (reference
    LocalBundleAdjustmentmain, src/Optimizer.cc:2875-2902). Returns
    (state, problem, result)."""
    cams, lm_ids = build_ba_window(st, kf)
    st = refresh_landmark_stats(st, cams, lm_ids, scale_factor, n_levels)
    prob = make_ba_problem(st, cams, lm_ids)
    ln_ids = None
    solve = ba_solve
    if with_lines:
        ln_ids = build_line_window(st, cams)
        prob = add_line_edges(st, cams, ln_ids, prob)
        solve = ba_solve_arbitrated
    res = solve(cam, prob, rounds=ba_rounds, iters=ba_iters, n_free=N_WINDOW)
    st = apply_ba_result(st, cams, lm_ids, prob, res, ln_ids=ln_ids)
    return st, prob, res


def mapping_step(st: MapState, kf: int, cam: Camera, scales: torch.Tensor, *,
                 scale_factor: float = 1.2, n_levels: int = 8, ba_rounds: int = 2,
                 ba_iters: int = 5, th_obs: int = 3, with_lines: bool = False,
                 k_bucket: int | None = None):
    """The per-keyframe mapping step: cull -> triangulate -> fuse -> local
    BA -> keyframe culling, in place on `st`, the line stages after their
    point stages with `with_lines`. Returns (state, stats [MSTAT_LEN]),
    see the MSTAT_* layout.

    `k_bucket`: the keyframe-table stages run on the first k_bucket rows
    (a view, so every write lands in the full tables); the caller passes
    the next power of two >= the live keyframe count, floor 32."""
    full_kfs = st.kfs
    if k_bucket is not None and k_bucket < full_kfs.Tcw.shape[0]:
        st = st._replace(kfs=KeyFrames(*[x[:k_bucket] for x in full_kfs]))
    st, _ = map_upkeep(st, kf, cam, scales, scale_factor, n_levels, th_obs,
                       with_lines)
    st, prob, res = local_ba(st, kf, cam, scale_factor, n_levels, ba_rounds,
                             ba_iters, with_lines)
    st, culled = cull_keyframes(st, kf, with_lines)
    # Host payload: the keyframe's post-BA pose, and for each culled
    # keyframe Tcp = Tcw_culled @ inv(Tcw_kf), its pose relative to the
    # live anchor at cull time (the reference's mTcp).
    Tkf = st.kfs.Tcw[kf]
    # inv_ex: no singularity check, which would wait for the device.
    Tcp = st.kfs.Tcw[culled.clamp(min=0).long()] @ torch.linalg.inv_ex(Tkf).inverse
    cull_info = torch.cat([culled.float()[:, None], Tcp.reshape(-1, 16)],
                          dim=1).reshape(-1)
    stats = torch.cat([
        torch.stack([st.n_pts.float(), torch.sum(prob.e_ok).float(),
                     torch.sum(res.e_inlier).float(), res.total_chi2]),
        Tkf.reshape(-1), cull_info,
        torch.stack([res.n_guarded.float(), res.n_state_revert.float(),
                     res.n_lm_singular.float()]),
    ])
    return st._replace(kfs=full_kfs), stats
