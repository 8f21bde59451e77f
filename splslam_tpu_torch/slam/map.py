"""The map as fixed-capacity struct-of-arrays tables on the device (port
of splslam_tpu/slam/map.py, stereo subset).

Unlike the reference, whose update functions return new immutable
states, the update functions here write the big tables IN PLACE and
return the state with its scalar counters replaced; callers must treat
the state they passed in as consumed. The counters (`n_pts`, `n_lns`,
`n_kfs`) are 0-dim int32 tensors on the device, so no update needs a
host round trip: a row is written through a 1-d index tensor
(`index_copy_`), never through a 0-dim tensor index, which would make the
host wait for the device. Descriptors are int32 with the bits of uint32
words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from splslam_tpu_torch.slam.frame import FrameData

NO_LM = -1


def _z(shape, device, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)


class MapPoints(NamedTuple):
    xyz: torch.Tensor        # [P,3]
    desc: torch.Tensor       # [P,8] int32 distinctive descriptor
    normal: torch.Tensor     # [P,3] mean viewing direction
    dmin: torch.Tensor       # [P] scale-invariance band
    dmax: torch.Tensor       # [P]
    n_visible: torch.Tensor  # [P] int32 (reference mnVisible)
    n_found: torch.Tensor    # [P] int32 (reference mnFound)
    n_obs: torch.Tensor      # [P] int32 keyframe observation count
    first_kf: torch.Tensor   # [P] int32
    valid: torch.Tensor      # [P] bool
    recent: torch.Tensor     # [P] bool — culling probation window

    @staticmethod
    def empty(p: int, device) -> "MapPoints":
        i32 = torch.int32
        return MapPoints(
            xyz=_z((p, 3), device), desc=_z((p, 8), device, i32),
            normal=_z((p, 3), device), dmin=_z((p,), device),
            dmax=torch.full((p,), 1e9, device=device),
            n_visible=_z((p,), device, i32), n_found=_z((p,), device, i32),
            n_obs=_z((p,), device, i32), first_kf=_z((p,), device, i32),
            valid=_z((p,), device, torch.bool),
            recent=_z((p,), device, torch.bool),
        )


class MapLines(NamedTuple):
    """3D line landmarks: start/mid/end points."""

    xyz: torch.Tensor        # [Q,3,3]
    desc: torch.Tensor       # [Q,8] int32
    avg_len2d: torch.Tensor  # [Q]
    n_visible: torch.Tensor  # [Q] int32
    n_found: torch.Tensor    # [Q] int32
    n_obs: torch.Tensor      # [Q] int32
    first_kf: torch.Tensor   # [Q] int32
    valid: torch.Tensor      # [Q] bool

    @staticmethod
    def empty(q: int, device) -> "MapLines":
        i32 = torch.int32
        return MapLines(
            xyz=_z((q, 3, 3), device), desc=_z((q, 8), device, i32),
            avg_len2d=_z((q,), device), n_visible=_z((q,), device, i32),
            n_found=_z((q,), device, i32), n_obs=_z((q,), device, i32),
            first_kf=_z((q,), device, i32), valid=_z((q,), device, torch.bool),
        )


class KeyFrames(NamedTuple):
    """Keyframe table; feature rows double as observation edges."""

    Tcw: torch.Tensor       # [K,4,4]
    xy: torch.Tensor        # [K,N,2]
    octave: torch.Tensor    # [K,N] int32
    sigma2: torch.Tensor    # [K,N]
    angle: torch.Tensor     # [K,N]
    desc: torch.Tensor      # [K,N,8] int32
    fvalid: torch.Tensor    # [K,N] bool
    u_right: torch.Tensor   # [K,N]
    depth: torch.Tensor     # [K,N]
    lm_idx: torch.Tensor    # [K,N] int32 landmark per keypoint, -1 none
    lseg: torch.Tensor      # [K,L,4]
    ldesc: torch.Tensor     # [K,L,8] int32
    langle: torch.Tensor    # [K,L]
    llen: torch.Tensor      # [K,L]
    lvalid: torch.Tensor    # [K,L] bool
    ll_idx: torch.Tensor    # [K,L] int32 map-line per line feature, -1 none
    loctave: torch.Tensor   # [K,L] int32
    valid: torch.Tensor     # [K] bool
    frame_id: torch.Tensor  # [K] int32
    ts: torch.Tensor        # [K] f32 timestamp

    @staticmethod
    def empty(k: int, n: int, l: int, device) -> "KeyFrames":
        i32, b = torch.int32, torch.bool
        return KeyFrames(
            Tcw=torch.eye(4, device=device).repeat(k, 1, 1),
            xy=_z((k, n, 2), device), octave=_z((k, n), device, i32),
            sigma2=torch.ones((k, n), device=device),
            angle=_z((k, n), device), desc=_z((k, n, 8), device, i32),
            fvalid=_z((k, n), device, b),
            u_right=torch.full((k, n), -1.0, device=device),
            depth=torch.full((k, n), -1.0, device=device),
            lm_idx=torch.full((k, n), NO_LM, dtype=i32, device=device),
            lseg=_z((k, l, 4), device), ldesc=_z((k, l, 8), device, i32),
            langle=_z((k, l), device), llen=_z((k, l), device),
            lvalid=_z((k, l), device, b),
            ll_idx=torch.full((k, l), NO_LM, dtype=i32, device=device),
            loctave=_z((k, l), device, i32), valid=_z((k,), device, b),
            frame_id=_z((k,), device, i32), ts=_z((k,), device),
        )


class MapState(NamedTuple):
    pts: MapPoints
    lns: MapLines
    kfs: KeyFrames
    n_pts: torch.Tensor  # 0-dim int32 allocation high-water mark
    n_lns: torch.Tensor
    n_kfs: torch.Tensor

    def to(self, device) -> "MapState":
        """A copy on `device` (always a copy: the tables are updated in
        place)."""
        def copy(x):
            return type(x)(*map(copy, x)) if isinstance(x, tuple) else \
                x.to(device, copy=True)
        return copy(self)

    @staticmethod
    def empty(p: int, q: int, k: int, n: int, l: int, device) -> "MapState":
        zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return MapState(
            pts=MapPoints.empty(p, device), lns=MapLines.empty(q, device),
            kfs=KeyFrames.empty(k, n, l, device),
            n_pts=zero(), n_lns=zero(), n_kfs=zero(),
        )

    @property
    def capacity_pts(self) -> int:
        """The point table's capacity."""
        return self.pts.xyz.shape[0]


def scale_band(depth: torch.Tensor, octave: torch.Tensor, scale_factor: float,
               n_levels: int):
    """Scale-invariance distance band of a new landmark (reference
    MapPoint::UpdateNormalAndDepth)."""
    level_scale = torch.pow(torch.full((), scale_factor, dtype=torch.float32,
                                       device=depth.device), octave.float())
    dmax = depth * level_scale
    dmin = dmax / (scale_factor ** (n_levels - 1))
    return dmin, dmax


def predict_octave(dist: torch.Tensor, dmax: torch.Tensor, scale_factor: float,
                   n_levels: int) -> torch.Tensor:
    """Predicted detection octave from distance (reference
    MapPoint::PredictScale)."""
    ratio = torch.clamp(dmax / torch.clamp(dist, min=1e-6), min=1e-6)
    lv = torch.ceil(torch.log(ratio) / torch.log(
        torch.full((), scale_factor, dtype=torch.float32, device=dist.device)))
    return torch.clamp(lv, 0, n_levels - 1).to(torch.int32)


def insert_keyframe(st: MapState, frame: FrameData, Tcw: torch.Tensor,
                    lm_idx: torch.Tensor, ll_idx: torch.Tensor,
                    frame_id: int, ts: float) -> tuple[MapState, torch.Tensor]:
    """Append a keyframe row (in place) and bump n_obs of its observed
    landmarks. Returns (state, kf_index as a 0-dim tensor)."""
    k = st.n_kfs.long().reshape(1)
    kfs = st.kfs
    f = frame.feat
    ln = frame.lines
    rows = (
        (kfs.Tcw, Tcw), (kfs.xy, f.xy), (kfs.octave, f.octave),
        (kfs.sigma2, f.sigma2), (kfs.angle, f.angle), (kfs.desc, f.desc),
        (kfs.fvalid, f.valid), (kfs.u_right, frame.u_right),
        (kfs.depth, frame.depth), (kfs.lm_idx, lm_idx), (kfs.lseg, ln.seg),
        (kfs.ldesc, ln.desc), (kfs.langle, ln.angle), (kfs.llen, ln.length),
        (kfs.lvalid, ln.valid), (kfs.ll_idx, ll_idx), (kfs.loctave, ln.octave),
    )
    for table, row in rows:
        table.index_copy_(0, k, row[None].to(table.dtype))
    kfs.valid.index_fill_(0, k, True)
    kfs.frame_id.index_fill_(0, k, frame_id)
    kfs.ts.index_fill_(0, k, ts)
    # Stereo observations count double (reference MapPoint::AddObservation).
    obs_w = torch.where(frame.u_right >= 0, 2, 1).to(torch.int32)
    st.pts.n_obs.index_add_(0, lm_idx.clamp(min=0).long(),
                            torch.where(lm_idx >= 0, obs_w, 0).to(torch.int32))
    st.lns.n_obs.index_add_(0, ll_idx.clamp(min=0).long(),
                            (ll_idx >= 0).to(torch.int32))
    return st._replace(n_kfs=st.n_kfs + 1), st.n_kfs


def create_stereo_points(
    st: MapState,
    kf_idx: torch.Tensor,
    frame: FrameData,
    Tcw: torch.Tensor,
    lm_idx: torch.Tensor,
    cam_fx: float,
    cam_fy: float,
    cam_cx: float,
    cam_cy: float,
    depth_limit: float,
    scale_factor: float,
    n_levels: int,
    max_new: int = 200,
) -> tuple[MapState, torch.Tensor]:
    """Create landmarks from stereo depth for unmatched keypoints,
    closest first, at most `max_new` (reference StereoInitialization /
    CreateNewKeyFrame, src/Tracking.cc:970-1040, 2337-2416). Writes the
    point table and the keyframe's lm_idx row in place. Returns (state,
    lm_idx updated with the new landmarks)."""
    f = frame.feat
    dev = lm_idx.device
    N = lm_idx.shape[0]
    can = f.valid & (frame.depth > 0) & (lm_idx < 0) & (frame.depth < depth_limit)
    order_key = torch.where(can, frame.depth, float("inf"))
    order = torch.argsort(order_key, stable=True)
    rank = torch.empty_like(lm_idx)
    rank[order] = torch.arange(N, dtype=lm_idx.dtype, device=dev)
    create = can & (rank < max_new)
    slot_off = torch.cumsum(create.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(create, st.n_pts + slot_off, 0)
    n_new = torch.sum(create.to(torch.int32), dtype=torch.int32)
    cap = st.pts.xyz.shape[0]
    create = create & (slots < cap)

    Twc = torch.linalg.inv_ex(Tcw).inverse   # inv_ex: no host sync
    z = frame.depth
    x = (f.xy[:, 0] - cam_cx) / cam_fx * z
    y = (f.xy[:, 1] - cam_cy) / cam_fy * z
    pc = torch.stack([x, y, z], dim=-1)
    pw = pc @ Twc[:3, :3].T + Twc[:3, 3]
    view = pw - Twc[:3, 3]
    dist = torch.linalg.norm(view, dim=-1)
    normal = view / torch.clamp(dist[:, None], min=1e-9)
    dmin, dmax = scale_band(dist, f.octave, scale_factor, n_levels)

    # Rows that create nothing write into a spare slot `cap`, sliced off.
    sl = torch.where(create, slots, cap).long()
    pts = st.pts
    writes = (
        (pts.xyz, pw), (pts.desc, f.desc), (pts.normal, normal),
        (pts.dmin, dmin), (pts.dmax, dmax), (pts.n_obs, 2),
        (pts.n_visible, 1), (pts.n_found, 1), (pts.first_kf, kf_idx),
        (pts.valid, True),
    )
    for table, val in writes:
        buf = torch.cat([table, table[:1]])
        if isinstance(val, torch.Tensor) and val.dim() > 0:
            buf[sl] = val.to(table.dtype)
        else:
            buf[sl] = torch.as_tensor(val, dtype=table.dtype, device=dev)
        table.copy_(buf[:cap])
    new_lm_idx = torch.where(create, slots.to(torch.int32), lm_idx)
    st.kfs.lm_idx[kf_idx.long()] = new_lm_idx
    return st._replace(n_pts=st.n_pts + n_new), new_lm_idx


def update_point_stats(st: MapState, idx: torch.Tensor, visible: torch.Tensor,
                       found: torch.Tensor) -> MapState:
    """Bump mnVisible/mnFound of the landmarks `idx` (-1 none) where
    `visible` / `found` (reference Tracking::SearchLocalPoints /
    TrackLocalMap), in place. Counters add, so repeated ids are summed."""
    safe = idx.clamp(min=0).long()
    ok = idx >= 0
    st.pts.n_visible.index_add_(0, safe, (ok & visible).to(torch.int32))
    st.pts.n_found.index_add_(0, safe, (ok & found).to(torch.int32))
    return st


def update_point_stats2(st: MapState, visible_ids: torch.Tensor,
                        found_ids: torch.Tensor) -> MapState:
    """Bump mnVisible/mnFound counters of tracked landmarks (in place)."""
    st.pts.n_visible.index_add_(0, visible_ids.clamp(min=0).long(),
                                (visible_ids >= 0).to(torch.int32))
    st.pts.n_found.index_add_(0, found_ids.clamp(min=0).long(),
                              (found_ids >= 0).to(torch.int32))
    return st


def update_line_stats(st: MapState, visible_ids: torch.Tensor,
                      found_ids: torch.Tensor, found_len: torch.Tensor) -> MapState:
    """Bump map-line visible/found counters and fold the observed 2D
    length into the running average, 0.7 old + 0.3 new (reference
    MapLine::IncreaseVisible/IncreaseFound + Update2DLineLength), in
    place. The reference writes the average with a scatter-set at
    clip(found_ids, 0): every row writes (rows without a map line write
    slot 0 its own old value), and the last write wins (`_last_writer`)."""
    lns = st.lns
    Q = lns.avg_len2d.shape[0]
    lns.n_visible.index_add_(0, visible_ids.clamp(min=0).long(),
                             (visible_ids >= 0).to(torch.int32))
    fsafe = found_ids.clamp(min=0).long()
    lns.n_found.index_add_(0, fsafe, (found_ids >= 0).to(torch.int32))
    old = lns.avg_len2d[fsafe]
    new = torch.where(found_ids >= 0, 0.7 * old + 0.3 * found_len, old)
    rows = torch.arange(fsafe.shape[0], device=fsafe.device)
    w = torch.full((Q,), -1, dtype=torch.long, device=fsafe.device)
    w.scatter_reduce_(0, fsafe, rows, "amax")
    lns.avg_len2d.copy_(torch.where(w >= 0, new[w.clamp(min=0)], lns.avg_len2d))
    return st


def landmark_membership(query: torch.Tensor, P: int) -> torch.Tensor:
    """[P] bool: which landmarks the observation row `query` (-1 = none)
    holds, by the reference's rule. The reference scatters `q >= 0` at
    `clip(q, 0)`, so landmark 0 and every -1 all write slot 0, and XLA's
    CPU scatter keeps the last write: slot 0 is True exactly when the
    last entry of `query` that is <= 0 is a 0 (False when there is
    none)."""
    dev = query.device
    member = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    # index_fill_ and a 1-d gather: writing a Python scalar through an
    # index tensor, or indexing with a 0-dim tensor, waits for the device
    member.index_fill_(0, torch.where(query > 0, query, P).long(), True)
    pos = torch.arange(query.shape[0], device=dev)
    last = torch.max(torch.where(query <= 0, pos, -1))
    member[0] = (last >= 0) & (query[last.clamp(min=0)[None]][0] == 0)
    return member[:P]


def covisibility_counts(st: MapState, lm_idx_query: torch.Tensor) -> torch.Tensor:
    """Shared-landmark counts between a query observation set and every
    keyframe (reference KeyFrame::UpdateConnections weights), with the
    reference's membership rule for landmark 0. [K] int32."""
    member = landmark_membership(lm_idx_query, st.pts.xyz.shape[0])
    kf_lm = st.kfs.lm_idx
    hit = member[kf_lm.clamp(min=0).long()] & (kf_lm >= 0)
    return torch.sum(hit.to(torch.int32), dim=1, dtype=torch.int32) \
        * st.kfs.valid.to(torch.int32)
