"""Public facade + host-side control flow (port of
splslam_tpu/slam/system.py, stereo subset).

Per frame the device runs `pipeline.vo_frame_step`; the host reads a
packed 24-float stats vector one frame later (`async_depth`, which
decides which frame becomes a keyframe, so it is kept) and applies the
reference's control flow: the reference-keyframe fallback, the lost
gate, the keyframe policy (NeedNewKeyFrame, src/Tracking.cc:2181-2336),
and the per-frame relative-pose trajectory log (src/System.cc:369-395).

This slice is stereo, points only, with local mapping, relocalization
and loop closing off. Asking for any of those, for lines, or for a mono
or RGB-D sensor raises NotImplementedError; nothing is dropped silently.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.slam import pipeline
from splslam_tpu_torch.slam.frame import LINES_LATER, FrameData, build_frame_stereo
from splslam_tpu_torch.slam.map import MapState
from splslam_tpu_torch.slam.pipeline import StepState
from splslam_tpu_torch.slam.tracking import bow_free_refkf_match


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class TrackingState(enum.Enum):
    SYSTEM_NOT_READY = -1
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def track_lost(n_in: int, n_ln_in: int, using_line: bool,
               recent_reloc: bool = False) -> bool:
    """The reference's TrackLocalMap(Both) accept gate, inverted. Point-only
    runs keep the floor of 10 point inliers."""
    if not using_line:
        return n_in < 10
    if recent_reloc and n_in < 30 and n_ln_in < 15:
        return True
    return n_in + n_ln_in < 12


@dataclass
class Settings:
    """Flat config mirroring the reference YAML keys. Local mapping,
    relocalization and loop closing default to off here: they belong to
    later slices and raise if enabled."""

    # Camera.*
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0
    fps: float = 30.0
    width: int = 640
    height: int = 480
    th_depth: float = 35.0
    # ORBextractor.*
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    # System.usingLine (later slice; raises if set)
    using_line: bool = False
    # capacities
    max_points: int = 65536
    max_maplines: int = 4096
    max_keyframes: int = 1024
    local_window: int = 2048
    # later slices (raise if enabled)
    enable_local_mapping: bool = False
    enable_relocalization: bool = False
    enable_loop_closing: bool = False
    # keyframe policy
    min_kf_gap: int = 1
    force_kf_every: int = 0
    # frames in flight before the host consumes their stats
    async_depth: int = 1

    def camera(self) -> Camera:
        return Camera.create(
            self.fx, self.fy, self.cx, self.cy, self.k1, self.k2,
            self.p1, self.p2, self.k3, self.bf, self.width, self.height,
        )


@dataclass
class _TrajEntry:
    ts: float
    Tcr: np.ndarray     # pose relative to reference keyframe
    ref_kf: int
    lost: bool
    Tcw: np.ndarray     # absolute (online estimate)


def _check_slice(settings: Settings, sensor: Sensor):
    if sensor != Sensor.STEREO:
        raise NotImplementedError(f"{sensor.name} sensor: later slice")
    if settings.using_line:
        raise NotImplementedError(LINES_LATER)
    for flag, what in (("enable_local_mapping", "local mapping"),
                       ("enable_relocalization", "relocalization (vocabulary)"),
                       ("enable_loop_closing", "loop closing (vocabulary)")):
        if getattr(settings, flag):
            raise NotImplementedError(f"{what}: later slice")


class System:
    """SPL-SLAM on PyTorch: `System(settings, Sensor.STEREO, device)`."""

    def __init__(self, settings: Settings, sensor: Sensor, device):
        _check_slice(settings, sensor)
        self.settings = settings
        self.sensor = sensor
        self.device = torch.device(device)
        self.cam = settings.camera()
        self.spec = PyramidSpec.create(
            settings.height, settings.width, settings.n_levels,
            settings.scale_factor, settings.n_features,
        )
        self.scales = torch.tensor(self.spec.scales, dtype=torch.float32,
                                   device=self.device)
        self.state = TrackingState.NO_IMAGES_YET
        self.th_depth_m = (
            float(settings.bf) / settings.fx * settings.th_depth
            if settings.bf > 0 else 1e9
        )
        self._reset_runtime()

    def _reset_runtime(self):
        s = self.settings
        # Keyframe line tables have capacity 1: points only (see module doc).
        self.map = MapState.empty(
            s.max_points, s.max_maplines, s.max_keyframes,
            self.spec.total_capacity, 1, self.device,
        )
        self.n_kfs = 0
        self.n_pts = 0
        self.frame_id = 0
        self.ref_kf = -1
        self.frames_since_kf = 0
        self.step: StepState | None = None
        self.last_Tcw_np = np.eye(4, dtype=np.float32)
        self.kf_pose_host: dict[int, np.ndarray] = {}
        self.trajectory: list[_TrajEntry] = []
        self._pending: deque = deque()   # (stats, ts, step_state, frame_id)
        self._pending_kf_out = None      # keyframe-creation output
        self._frames_lost = 0

    # ------------------------------------------------------------------
    # public API (reference System.h:84-128)
    # ------------------------------------------------------------------
    def track_stereo(self, img_left, img_right, timestamp: float) -> np.ndarray:
        """Track one rectified stereo pair (8-bit grayscale); returns the
        latest consumed Tcw (one frame behind, see `async_depth`)."""
        imgs = torch.from_numpy(
            np.stack([np.asarray(img_left), np.asarray(img_right)])
            .astype(np.uint8)
        ).to(self.device)
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            frame = build_frame_stereo(imgs[0].float(), imgs[1].float(),
                                       self.cam, self.spec)
            self._stereo_initialize(frame, timestamp)
            return self.last_Tcw_np.copy()
        self.map, new_step, stats = pipeline.vo_frame_step(
            imgs, self.map, self.step, self.th_depth_m, self.ref_kf,
            self.cam, self.spec, self.scales,
            m_local=self.settings.local_window,
            scale_factor=self.settings.scale_factor,
            n_levels=self.settings.n_levels,
        )
        return self._enqueue_step(new_step, stats, timestamp)

    def get_tracking_state(self) -> TrackingState:
        self.drain()
        return self.state

    def reset(self):
        self._reset_runtime()
        self.state = TrackingState.NO_IMAGES_YET

    # ------------------------------------------------------------------
    # per-frame control flow (stats consumed `async_depth` frames late)
    # ------------------------------------------------------------------
    def _enqueue_step(self, new_step: StepState, stats, ts: float) -> np.ndarray:
        self.step = new_step
        self.frame_id += 1
        self._pending.append((stats, ts, new_step, self.frame_id))
        while len(self._pending) > self.settings.async_depth:
            self._process_one()
        return self.last_Tcw_np.copy()

    def drain(self):
        """Consume all in-flight frame stats (called before any state or
        trajectory query)."""
        while self._pending:
            self._process_one()

    def _process_one(self):
        stats_dev, ts, step_state, fid = self._pending.popleft()
        stats = stats_dev.cpu().numpy()
        self._resolve_kf_out()
        n_mm = int(stats[pipeline.S_N_MM])
        n_in = int(stats[pipeline.S_N_IN])
        n_ln_in = int(stats[pipeline.S_N_LN_IN])
        Tcw_np = stats[pipeline.S_POSE].reshape(4, 4).astype(np.float32)

        if n_mm < 20 or n_in < 10:
            # Fallback: reference keyframe match (TrackReferenceKeyFrame).
            res = self._track_refkf(step_state.frame)
            n_in = int(res.n_inliers)
            if n_in >= 10:
                n_ln_in = 0
                Tcw_np = res.Tcw.cpu().numpy().astype(np.float32)
                step_state = step_state._replace(
                    lm_gid=res.lm_gid,
                    lm_xyz=self.map.pts.xyz[res.lm_gid.clamp(min=0).long()],
                    Tcw=res.Tcw,
                    velocity=torch.eye(4, device=self.device),
                )
                # Resync the live tracker only if this is still the newest
                # dispatched frame.
                if fid == self.frame_id:
                    self.step = step_state

        if track_lost(n_in, n_ln_in, self.settings.using_line):
            self.state = TrackingState.LOST
            self._frames_lost += 1
            # Lost right after init with a tiny map: full reset
            # (reference Tracking.cc:649-657).
            if self.n_kfs <= 5 and self._frames_lost > 5:
                self.reset()
                return
            self._log_frame(ts, self.last_Tcw_np, lost=True)
            return

        self._frames_lost = 0
        self.state = TrackingState.OK
        if self._need_new_keyframe(stats, n_in):
            self._create_keyframe(step_state, Tcw_np, ts)
        else:
            self.frames_since_kf += 1
        self.last_Tcw_np = Tcw_np
        self._log_frame(ts, Tcw_np, lost=False)

    def _track_refkf(self, frame: FrameData):
        k = self.ref_kf
        kfs = self.map.kfs
        lm = kfs.lm_idx[k]
        return bow_free_refkf_match(
            self.cam, frame, kfs.desc[k], kfs.angle[k], kfs.fvalid[k], lm,
            self.map.pts.xyz[lm.clamp(min=0).long()],
            torch.from_numpy(self.last_Tcw_np).to(self.device),
        )

    def _stereo_initialize(self, frame: FrameData, ts: float):
        """Reference Tracking::StereoInitialization (src/Tracking.cc:970)."""
        n_depth = int(torch.sum(frame.depth > 0))
        if n_depth < 100:
            self.state = TrackingState.NOT_INITIALIZED
            self.frame_id += 1
            return
        step = StepState.fresh(frame, torch.eye(4, device=self.device))
        self.map, self.step, out = pipeline.add_keyframe_step(
            self.map, step, self.frame_id, ts, 1e9, self.cam,
            scale_factor=self.settings.scale_factor,
            n_levels=self.settings.n_levels, max_new=1000,
        )
        out = out.cpu().numpy()
        kf = int(out[0])
        self.n_kfs = 1
        self.n_pts = int(out[2])
        self.ref_kf = kf
        self.frames_since_kf = 0
        self.kf_pose_host[kf] = np.eye(4, dtype=np.float32)
        self.state = TrackingState.OK
        self.last_Tcw_np = np.eye(4, dtype=np.float32)
        self._log_frame(ts, self.last_Tcw_np, lost=False)
        self.frame_id += 1

    def _need_new_keyframe(self, stats: np.ndarray, n_in: int) -> bool:
        """Reference Tracking::NeedNewKeyFrame (src/Tracking.cc:2181-2336),
        stereo, points only: (c1a || c1b || c1c) && c2."""
        if self.n_kfs >= self.settings.max_keyframes - 1:
            return False
        if self.settings.force_kf_every > 0:
            return self.frames_since_kf >= self.settings.force_kf_every
        max_frames = int(self.settings.fps)
        n_tracked_close = int(stats[pipeline.S_CLOSE_TRACKED])
        n_untracked_close = int(stats[pipeline.S_CLOSE_UNTRACKED])
        need_close = (n_tracked_close < 100) and (n_untracked_close > 70)
        if self.frames_since_kf < self.settings.min_kf_gap:
            return False
        ref_matches = max(int(stats[pipeline.S_REF_MATCHES]), 1)
        th_ratio = 0.4 if self.n_kfs < 2 else 0.75
        c1a = self.frames_since_kf >= max_frames
        c1b = self.frames_since_kf >= self.settings.min_kf_gap
        c1c = (n_in < ref_matches * 0.25) or need_close
        c2 = ((n_in < ref_matches * th_ratio) or need_close) and n_in > 15
        return (c1a or c1b or c1c) and c2

    def _create_keyframe(self, step_state: StepState, Tcw_np: np.ndarray,
                         ts: float):
        self.map, new_state, out = pipeline.add_keyframe_step(
            self.map, step_state, self.frame_id, ts, self.th_depth_m, self.cam,
            scale_factor=self.settings.scale_factor,
            n_levels=self.settings.n_levels, max_new=200,
        )
        kf = self.n_kfs  # keyframes are appended densely
        self.n_kfs += 1
        self.ref_kf = kf
        self.frames_since_kf = 0
        self.kf_pose_host[kf] = Tcw_np.copy()
        if step_state is self.step:
            self.step = new_state
        self._pending_kf_out = out

    def _resolve_kf_out(self):
        if self._pending_kf_out is not None:
            self.n_pts = int(self._pending_kf_out[2])
            self._pending_kf_out = None

    def _log_frame(self, ts: float, Tcw_np: np.ndarray, lost: bool):
        Trw = self.kf_pose_host.get(self.ref_kf, np.eye(4, dtype=np.float32))
        Tcr = Tcw_np @ np.linalg.inv(Trw)
        self.trajectory.append(
            _TrajEntry(ts, Tcr, self.ref_kf, lost, Tcw_np.copy()))

    # ------------------------------------------------------------------
    # trajectory export (reference System.cc:340-540)
    # ------------------------------------------------------------------
    def poses(self) -> np.ndarray:
        """All per-frame camera-to-world poses [F,4,4] (online estimates)."""
        self.drain()
        return np.stack([np.linalg.inv(e.Tcw) for e in self.trajectory])

    def _reconstructed(self, skip_lost: bool):
        kf_Tcw = self.map.kfs.Tcw.cpu().numpy()
        for e in self.trajectory:
            if skip_lost and e.lost:
                continue
            Trw = kf_Tcw[e.ref_kf] if e.ref_kf >= 0 else np.eye(4)
            yield e, np.linalg.inv(e.Tcr @ Trw)

    def save_trajectory_tum(self, path: str):
        """TUM format: ts tx ty tz qx qy qz qw of Twc, reconstructed against
        final keyframe poses (reference System::SaveTrajectoryTUM)."""
        self.drain()
        with open(path, "w") as f:
            for e, Twc in self._reconstructed(skip_lost=True):
                t = Twc[:3, 3]
                q = _rot_to_quat(Twc[:3, :3])
                f.write(
                    f"{e.ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """KITTI format: 12 entries of Twc per line (reference
        System::SaveTrajectoryKITTI)."""
        self.drain()
        with open(path, "w") as f:
            for _, Twc in self._reconstructed(skip_lost=False):
                row = Twc[:3, :4].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [qx,qy,qz,qw]."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s, 0.25 * s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q
