"""The reference's per-stage timing table at KITTI size: the port of
bench_mapping.py.

The map is `io/synth_map.py::make_synthetic_map` (12 keyframes of 2000
features at 1241x376, bench_mapping.py:57): every stage has fixed
shapes, so its time depends on the table sizes and the observation
density, not on how the map was made. Each of BASELINE.md's ten rows is
timed under its name (bench_mapping.py:147-308): its synced wall a call
and its device time by CUDA events around back-to-back calls. Each
timed call starts from a fresh copy of the map made before the clock
starts (the stages update the tables in place, as the JAX bench's
pools of donated copies). Then "Tracking+mapping overlapped"
(bench_mapping.py:317-335), which on one CUDA stream measures the
mapping step's launches and 8 initial-pose-tracking calls enqueued in
turn and synced once: the stream runs them one after another.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from splslam_tpu_torch.bench.common import Bench, cuts, launches, summary
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.io.synth_map import make_synthetic_map
from splslam_tpu_torch.io.synthetic import PlaneScene, make_texture
from splslam_tpu_torch.ops import orb_kernel
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.optim.ba import ba_solve
from splslam_tpu_torch.optim.pose_gn import PointObs, pose_optimize
from splslam_tpu_torch.slam import mapping_ops as MO
from splslam_tpu_torch.slam import pipeline as P
from splslam_tpu_torch.slam import tracking as T
from splslam_tpu_torch.slam.map import KeyFrames


@dataclass(frozen=True)
class Size:
    n_kfs: int = 12
    n_feat: int = 2000
    width: int = 1241
    height: int = 376
    fx: float = 718.0
    baseline: float = 0.54
    n_levels: int = 8
    p_cap: int = 65536
    k_cap: int = 256
    local_window: int = 2048
    calls: int = 5            # timed calls a row a repeat, and as many under events
    overlap_frames: int = 8   # bench_mapping.py:321


FULL = Size()
SMALL = Size(n_kfs=5, n_feat=400, width=320, height=240, fx=200.0, baseline=0.12,
             n_levels=4, p_cap=8192, k_cap=32, local_window=1024, calls=1,
             overlap_frames=2)


def map_kwargs(size: Size = FULL) -> dict:
    """`make_synthetic_map`'s arguments (bench_mapping.py:57-60)."""
    return dict(n_kfs=size.n_kfs, n_feat=size.n_feat, p_cap=size.p_cap,
                k_cap=size.k_cap, width=size.width, height=size.height, fx=size.fx,
                baseline=size.baseline, n_levels=size.n_levels)


def camera(size: Size = FULL) -> Camera:
    return Camera.create(size.fx, size.fx, size.width / 2.0, size.height / 2.0,
                         bf=size.fx * size.baseline, width=size.width,
                         height=size.height)


def k_bucket(n_kfs: int, k_cap: int) -> int:
    """The keyframe-axis bucket `LocalMapper` dispatches the K-sized
    stages on: the next power of two >= the live keyframes, floor 32."""
    return min(k_cap, max(32, 1 << (max(n_kfs, 1) - 1).bit_length()))


def _bucketed(m, kb: int):
    return m._replace(kfs=KeyFrames(*[x[:kb] for x in m.kfs]))


def _rendered_pair(size: Size, dev) -> torch.Tensor:
    """A rendered stereo pair [1,2,H,W] uint8 (bench_mapping.py:176-189)."""
    scene = PlaneScene(make_texture(seed=1), z0=8.0, z1=25.0)
    K3 = np.array([[size.fx, 0, size.width / 2], [0, size.fx, size.height / 2],
                   [0, 0, 1]], np.float32)
    Twc = np.eye(4)
    imgL = scene.render(K3, Twc, size.height, size.width)
    Twc_r = Twc.copy()
    Twc_r[0, 3] += size.baseline
    imgR = scene.render(K3, Twc_r, size.height, size.width)
    return torch.from_numpy(np.stack([imgL, imgR]).astype(np.uint8)[None]).to(dev)


def _scatter_obs(fr, mt, gid_rows, xyz_rows, gid0, xyz0):
    """Associations after a match `mt` (row -> frame column) and the
    point observations they make."""
    N = fr.feat.capacity
    ok = mt >= 0
    gid = T._scatter_rows(N, mt, ok, torch.where(ok, gid_rows, -1), gid0)
    xyz = T._scatter_rows(N, mt, ok, xyz_rows, xyz0)
    return gid, PointObs(xyz_w=xyz, uv=fr.feat.xy, inv_sigma2=1.0 / fr.feat.sigma2,
                         mask=gid != -1)


class Stages:
    """The stage programs of bench_mapping.py on one synthetic map."""

    def __init__(self, size: Size, dev):
        self.size = size
        self.dev = dev
        self.cam = camera(size)
        self.scales = torch.tensor([1.2 ** i for i in range(size.n_levels)],
                                   dtype=torch.float32, device=dev)
        self.spec = PyramidSpec.create(size.height, size.width, size.n_levels, 1.2,
                                       size.n_feat)
        self.base, self.frame, self.step, _ = make_synthetic_map(**map_kwargs(size),
                                                                 device=dev)
        self.kf = size.n_kfs - 1
        self.kb = k_bucket(size.n_kfs, size.k_cap)
        self.pair = _rendered_pair(size, dev)
        self.n_pts0 = int(self.base.n_pts)
        self.n_valid0 = int(self.base.pts.valid.sum())

    def copy(self):
        return self.base.to(self.dev)

    def copy_bucketed(self):
        return _bucketed(self.base.to(self.dev), self.kb)

    # ---- tracking side ----
    def feature_extraction(self, _=None):
        return P.build_frames_batch(self.pair, self.cam, self.spec, self.scales,
                                    line_capacity=1)

    def initial_pose(self, _=None):
        """Motion-model projection match + pose GN (SearchByProjection +
        PoseOptimization)."""
        fr, stp = self.frame, self.step
        T_pred = stp.velocity @ stp.Tcw
        mm, _ = T.motion_model_match(
            self.cam, self.scales, T_pred, fr, stp.frame.feat.octave,
            stp.frame.feat.angle, stp.frame.feat.desc, stp.lm_xyz, stp.lm_gid != -1, 7.0)
        N = fr.feat.capacity
        gid, obs = _scatter_obs(
            fr, mm, stp.lm_gid, stp.lm_xyz,
            torch.full((N,), -1, dtype=torch.int32, device=self.dev),
            torch.zeros((N, 3), device=self.dev))
        return pose_optimize(T_pred, self.cam, obs).Tcw, gid

    def track_local_map(self, _=None):
        """Covisible-window frustum match + pose GN (UpdateLocalMap,
        SearchLocalPoints, PoseOptimization)."""
        fr, stp = self.frame, self.step
        win = P.assemble_local_window(self.base, stp.lm_gid, self.size.local_window)
        mt, _, _ = T.local_map_match(self.cam, self.scales, stp.Tcw, fr, win,
                                     stp.lm_gid != -1, 1.2, self.size.n_levels)
        gid, obs = _scatter_obs(fr, mt, win.ids, win.xyz, stp.lm_gid, stp.lm_xyz)
        return pose_optimize(stp.Tcw, self.cam, obs).Tcw, gid

    # ---- mapping side (each on its own copy) ----
    def keyframe_insertion(self, m):
        m, _, out = P.add_keyframe_step(m, self.step, 999, 99.9,
                                        35.0 * self.size.baseline, self.cam, 1.2,
                                        self.size.n_levels)
        return out

    def culling(self, m):
        return MO.cull_points(m, self.kf).pts.valid

    def creation(self, m):
        nb, _ = MO._topk_covisible(m, self.kf, MO.N_NEIGH)
        return MO.create_new_points(m, self.cam, self.scales, self.kf, nb, 1.2,
                                    self.size.n_levels).n_pts

    def fuse(self, m):
        nb, _ = MO._topk_covisible(m, self.kf, MO.N_NEIGH)
        return MO.fuse_neighbors(m, self.cam, self.scales, self.kf, nb, 1.2,
                                 self.size.n_levels).pts.n_obs

    def local_ba(self, m):
        cams, lm_ids = MO.build_ba_window(m, self.kf)
        prob = MO.make_ba_problem(m, cams, lm_ids)
        return ba_solve(self.cam, prob, rounds=2, iters=5, n_free=MO.N_WINDOW)

    def keyframe_culling(self, m):
        return MO.cull_keyframes(m, self.kf)[0].kfs.valid

    def mapping_total(self, m):
        return MO.mapping_step(m, self.kf, self.cam, self.scales,
                               n_levels=self.size.n_levels, k_bucket=self.kb)[1]

    def overlapped(self, m):
        """A mapping step (on the full tables, as bench_mapping.py:324)
        and `overlap_frames` initial-pose-tracking calls behind it on the
        same stream."""
        _, stats = MO.mapping_step(m, self.kf, self.cam, self.scales,
                                   n_levels=self.size.n_levels)
        outs = [self.initial_pose() for _ in range(self.size.overlap_frames)]
        return stats, outs[-1][1]


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x.float()).all())


def _time_row(b: Bench, fn, make_input, calls: int):
    """Per repeat: `calls` synced calls, each on a fresh input made
    before the clock starts, then CUDA events around `calls` more back to
    back. Returns (synced ms per repeat, event ms per repeat, launches per
    repeat, the last output)."""
    walls, events, counted = [], [], []
    out = None
    for _ in range(b.repeats):
        b.settle()
        n0 = launches()
        ms = []
        for x in [make_input() for _ in range(calls)]:
            out, t = b.timed(fn, x)
            ms.append(t)
        walls.append(ms)
        if b.cuda:
            events.append(b.events_ms(fn, [make_input() for _ in range(calls)]))
        counted.append(launches() - n0)
    return walls, events, counted, out


def run(b: Bench, size: Size = FULL) -> list[dict]:
    b.reduced = cuts(size, FULL)
    if b.cuda:
        b.setup("kernel build", orb_kernel.build)
    S = b.setup("map build", Stages, size, b.device)
    # warm-up: the first call of every program (the mapping step runs
    # each mapping stage) sets up the libraries, outside every row
    b.setup("warm-up", lambda: (S.mapping_total(S.copy()), S.keyframe_insertion(S.copy()),
                                S.feature_extraction(), S.track_local_map()))
    n = size.calls

    def shared_map():      # the tracking stages read the map without changing it
        return None

    def stage(name, metric, baseline, fn, make_input, check, orb=0, per=1, **extra):
        """One row: `check(out)` on the last output, and `orb` ORB launches
        a call on the card; `per` divides every time (a call that stands
        for `per` frames)."""
        walls, events, counted, out = _time_row(b, fn, make_input, n)
        stats = summary([[w / per for w in r] for r in walls])
        trace = b.trace(f"one {name} call", lambda: fn(make_input()), stats["median_ms"],
                        per=per)
        ev = [e / per for e in events if e is not None]
        want = orb * n * (2 if b.cuda else 0)      # synced calls and event calls
        checks = {**check(out), f"{orb} ORB launch a call on the card":
                  all(c == want for c in counted)}
        return b.row(
            metric, stats["median_ms"], "ms", checks, baseline=baseline,
            ms=stats["median_ms"], stage=name, **stats,
            events_ms=ev or None,
            events_median_ms=float(np.median(ev)) if ev else None,
            sample="the synced wall of one call on a fresh map copy; events_ms: CUDA "
                   f"events around {n} back-to-back calls over {n}",
            **extra, trace=trace)

    ba = stage("Local BA / KF", "kitti_local_ba_ms_per_keyframe", "kitti_local_ba",
               S.local_ba, S.copy_bucketed,
               lambda r: {"chi2 finite": _finite(r.total_chi2),
                          "no state revert": int(r.n_state_revert) == 0})
    total = stage("Mapping total / KF", "kitti_mapping_total_ms_per_keyframe",
                  "kitti_mapping_total", S.mapping_total, S.copy,
                  lambda r: {"stats finite": _finite(r),
                             "landmarks created": int(r[0]) > S.n_pts0,
                             "no state revert": int(r[MO.MSTAT_REVERT]) == 0},
                  k_bucket=S.kb)
    fe = stage("Feature extraction", "kitti_feature_extraction_ms_per_frame",
               "kitti_feature_extraction", S.feature_extraction, shared_map,
               lambda r: {"keypoints in both images": int(r[0].feat.valid.sum()) > 0
                          and bool((r[0].u_right >= 0).any())}, orb=1)
    ip = stage("Initial pose tracking", "kitti_initial_pose_tracking_ms_per_frame",
               "kitti_initial_pose_tracking", S.initial_pose, shared_map,
               lambda r: {"pose finite": _finite(r[0]), "matches": int((r[1] >= 0).sum()) > 0})
    tl = stage("Track local map", "kitti_track_local_map_ms_per_frame",
               "kitti_track_local_map", S.track_local_map, shared_map,
               lambda r: {"pose finite": _finite(r[0]), "matches": int((r[1] >= 0).sum()) > 0})
    tt_ms = fe["value"] + ip["value"] + tl["value"]
    tracking_total = b.row(
        "kitti_tracking_total_ms_per_frame_sum_of_stages", tt_ms, "ms",
        {"its three stages ok": fe["ok"] and ip["ok"] and tl["ok"]},
        baseline="kitti_tracking_total", ms=tt_ms, stage="Tracking total",
        value_from="the sum of the three tracking stages' medians "
                   "(kitti_stereo_tracking_* measure whole frames)")
    ki = stage("KeyFrame insertion", "kitti_keyframe_insertion_ms_per_keyframe",
               "kitti_keyframe_insertion", S.keyframe_insertion, S.copy,
               lambda r: {"inserted as keyframe n_kfs": int(r[0]) == size.n_kfs,
                          "landmarks created": int(r[2]) > S.n_pts0})
    cu = stage("Map feature culling", "kitti_map_feature_culling_ms_per_keyframe",
               "kitti_map_feature_culling", S.culling, S.copy_bucketed,
               lambda r: {"no landmark revived": int(r.sum()) <= S.n_valid0})
    fuse_walls, _, _, _ = _time_row(b, S.fuse, S.copy_bucketed, n)
    cr = stage("Map features creation", "kitti_map_features_creation_ms_per_keyframe",
               "kitti_map_features_creation", S.creation, S.copy_bucketed,
               lambda r: {"landmarks created": int(r) > S.n_pts0},
               fuse=summary(fuse_walls),
               fuse_note="SearchInNeighbors fuse, timed apart (bench_mapping.py:267)")
    kc = stage("KeyFrame culling", "kitti_keyframe_culling_ms_per_keyframe",
               "kitti_keyframe_culling", S.keyframe_culling, S.copy_bucketed,
               lambda r: {"at most 2 keyframes culled":
                          int(r.sum()) >= size.n_kfs - MO.MAX_KF_CULL})
    ov = stage("Tracking+mapping overlapped", "kitti_tracking_mapping_one_stream_ms_per_frame",
               None, S.overlapped, S.copy,
               lambda r: {"stats finite": _finite(r[0]), "matches": int((r[1] >= 0).sum()) > 0},
               per=size.overlap_frames,
               measures=f"one CUDA stream: a mapping step's launches, then "
                        f"{size.overlap_frames} initial-pose-tracking calls, synced once; "
                        "the stream runs them one after another (no concurrency); every "
                        f"time is the call's over {size.overlap_frames}")
    return [ba, total, fe, ip, tl, tracking_total, ki, cu, cr, kc, ov]
