"""Public facade + host-side control flow (port of
splslam_tpu/slam/system.py: stereo, monocular and RGB-D).

Per frame the device runs `pipeline.vo_frame_step` (stereo),
`pipeline.vo_frame_step_rgbd` (RGB-D) or `pipeline.vo_frame_step_mono`
after the two-view bootstrap of `slam/mono.py` (monocular); the host reads a
packed 24-float stats vector one frame later (`async_depth`, which
decides which frame becomes a keyframe, so it is kept) and applies the
reference's control flow: the reference-keyframe fallback, the lost
gate, the keyframe policy (NeedNewKeyFrame, src/Tracking.cc:2181-2336),
and the per-frame relative-pose trajectory log (src/System.cc:369-395).

After each keyframe insertion the local mapper runs the mapping step
(`slam/local_mapping.py`); its stats are read one keyframe late.

After each keyframe its BoW row enters the keyframe database
(`bow/vocabulary.py`) and, with loop closing on, the loop closer runs
detection and Sim3 verification (`slam/loop_closing.py`). By default it
records verified loops without correcting them, as the reference's
kill-switch does; with `enable_loop_correction` it corrects them
(essential graph, SearchAndFuse, global BA). A frame that fails the lost gate is relocalized against the
keyframe database (`slam/reloc.py`) before it is declared LOST.

Every sensor runs with the JAX package's defaults: local mapping,
relocalization and loop detection on, loop correction off; with lines
(`using_line`) too: the line mapping stages, the EPnL relocalization seed
and global BA with line edges. Localization mode
(`activate_localization_mode`) tracks against the frozen map plus
temporal points and inserts no keyframe. The vocabulary is a bundled
`.npz` or the reference's ORBvoc.txt. `StageTimer` keeps the per-stage
host wall clock (`System.timers`), `device_trace` a profiler trace.
`save_map` / `load_map` write and read the JAX package's checkpoint keys,
so either package loads the other's map.
"""

from __future__ import annotations

import enum
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from splslam_tpu_torch import convert
from splslam_tpu_torch.bow import vocabulary as V
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.slam import mono, pipeline, reloc
from splslam_tpu_torch.slam.frame import FrameData, build_frame_rgbd, build_frame_stereo
from splslam_tpu_torch.slam.local_mapping import LocalMapper
from splslam_tpu_torch.slam.loop_closing import LoopCloser
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
    """Flat config mirroring the reference YAML keys, with the JAX
    package's defaults."""

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
    rgb: int = 1                    # Camera.RGB: a no-op for grayscale input
    th_depth: float = 35.0
    depth_map_factor: float = 1.0   # 1 / DepthMapFactor: depth units -> metres
    # ORBextractor.*
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    # read from the YAML and unused, as in the JAX package: the FAST
    # threshold is fixed (ops/orb.py::detect)
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    # Lineextractor.* / System.usingLine / System.usingLsdFeature
    using_line: bool = False
    line_features: int = 128
    using_lsd: bool = True              # True: "grow" (LSD analog), False: "fld"
    line_n_levels: int = 2              # Lineextractor.nLevels
    line_min_length_ratio: float = 0.0  # Lineextractor.min_line_length_ratio
    # capacities
    max_points: int = 65536
    max_maplines: int = 4096
    max_keyframes: int = 1024
    local_window: int = 2048
    # mapping: two 5-iteration local-BA rounds with a chi2
    # re-classification between them (reference Optimizer.cc:2713-2764)
    enable_local_mapping: bool = True
    local_ba_window: int = 8   # unused, as in the JAX package (mapping_ops.N_WINDOW)
    local_ba_rounds: int = 2
    local_ba_iters: int = 5
    # relocalization / loop detection
    enable_relocalization: bool = True
    vocabulary_path: str | None = None  # None -> bundled vocabulary (.npz)
    reloc_min_inliers: int = 50         # reference Tracking.cc:3049
    # loop closing: detection + Sim3 verification when a vocabulary is
    # loaded; correction off, the reference's kill-switch
    # (src/LoopClosing.cc:390-392); True corrects every verified loop
    enable_loop_closing: bool = True
    enable_loop_correction: bool = False
    # keyframe policy
    min_kf_gap: int = 1
    force_kf_every: int = 0
    # frames in flight before the host consumes their stats
    async_depth: int = 1
    # batch mode (`track_*_batch`): with batch_defer_stats the host reads a
    # batch's stats only once more than batch_defer_depth batches are in
    # flight, so it queues that many batches ahead of the device; keyframe,
    # loss and relocalization decisions then act that many batches late
    batch_defer_stats: bool = False
    batch_defer_depth: int = 1

    def camera(self) -> Camera:
        return Camera.create(
            self.fx, self.fy, self.cx, self.cy, self.k1, self.k2,
            self.p1, self.p2, self.k3, self.bf, self.width, self.height,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 1e-12 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


class _StatsFetch:
    """One batch's stats on their way to the host: on the GPU an
    asynchronous copy into pinned memory and an event behind it, which
    `get` waits for; on the CPU a copy."""

    def __init__(self, stats: torch.Tensor):
        self._event = None
        if stats.is_cuda:
            self._host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
            self._host.copy_(stats, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = stats.clone()

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclass
class _TrajEntry:
    ts: float
    Tcr: np.ndarray     # pose relative to reference keyframe
    ref_kf: int
    lost: bool
    Tcw: np.ndarray     # absolute (online estimate)


class StageTimer:
    """Per-stage host wall-clock accumulator (the reference's PL_SLAM::Timer
    rows, src/Tracking.cc:381-413, src/LocalMapping.cc:139-235). On a GPU a
    row times the host's side: what it enqueues, and the stats it waits for
    one frame late."""

    def __init__(self):
        self.samples: dict[str, list[float]] = {}

    def add(self, stage: str, ms: float):
        self.samples.setdefault(stage, []).append(ms)

    @contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, (time.perf_counter() - t0) * 1e3)

    def report(self) -> dict:
        out = {}
        for k, v in self.samples.items():
            arr = np.array(v)
            out[k] = {"mean_ms": float(arr.mean()),
                      "median_ms": float(np.median(arr)), "n": len(v)}
        return out

    def pretty(self) -> str:
        lines = ["stage                         mean ms   median ms      n"]
        for k, s in self.report().items():
            lines.append(f"{k:<28}{s['mean_ms']:>10.2f}{s['median_ms']:>12.2f}"
                         f"{s['n']:>7d}")
        return "\n".join(lines)


@contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace (host and, on a CUDA build, device
    activities) around a block of SLAM calls, written for TensorBoard
    (`tensorboard --logdir log_dir`):

        with device_trace("slam_trace"):
            for i, (l, r) in enumerate(frames):
                slam.track_stereo(l, r, i * 0.1)
    """
    from torch.profiler import profile, supported_activities, tensorboard_trace_handler

    with profile(activities=supported_activities(),
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _load_vocab(path: str, device) -> V.Vocab:
    """A vocabulary `.npz`, or the reference's ORBvoc.txt text format."""
    return (V.load_orbslam_txt if path.endswith(".txt") else V.load)(path, device)


class System:
    """SPL-SLAM on PyTorch: `System(settings, sensor, device)` with
    `Sensor.STEREO`, `Sensor.RGBD` or `Sensor.MONOCULAR`."""

    def __init__(self, settings: Settings, sensor: Sensor, device):
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
        self.localization_only = False
        # stereo and RGB-D: the stereo keyframe policy, and keyframes that
        # create landmarks from depth
        self.has_depth = sensor in (Sensor.STEREO, Sensor.RGBD)
        self.th_depth_m = (
            float(settings.bf) / settings.fx * settings.th_depth
            if settings.bf > 0 else 1e9
        )
        # Line tables collapse to 1 slot when lines are off. line_cfg =
        # (backend, octaves, min length) from the reference's YAML keys; the
        # minimum length scales with the image's short side when set.
        self.line_cap = settings.line_features if settings.using_line else 1
        ml = settings.line_min_length_ratio * min(settings.width, settings.height)
        self.line_cfg = ("grow" if settings.using_lsd else "fld",
                         int(settings.line_n_levels),
                         float(ml) if ml > 0 else 24.0)
        # the BoW vocabulary (None -> the largest bundled one)
        self.vocab = (_load_vocab(settings.vocabulary_path or V.default_vocab_path(),
                                  self.device)
                      if settings.enable_relocalization else None)
        self._reset_runtime()

    def _reset_runtime(self):
        s = self.settings
        self.map = MapState.empty(
            s.max_points, s.max_maplines, s.max_keyframes,
            self.spec.total_capacity, self.line_cap, self.device,
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
        # (_StatsFetch, timestamps, step_state, staged images, frame id
        # before the batch) of each batch in flight
        self._pending_batches: deque = deque()
        self._batch_recovering = False   # inside a lost batch's replay
        self._pending_kf_out = None      # keyframe-creation output
        self._frames_lost = 0
        self._last_reloc_fid = -(10 ** 9)
        self.mono_state = None   # the monocular bootstrap's reference frame
        self.init_used_h = None  # which two-view model won mono init
        self.timers = StageTimer()
        # The keyframe database: one sparse BoW row per keyframe slot
        # (reference KeyFrameDatabase, include/KeyFrameDatabase.h:66).
        if self.vocab is not None:
            self.bow_n_words = self.vocab.n_words
            self.kf_bow = V.BowTable.empty(s.max_keyframes,
                                           self.spec.total_capacity,
                                           self.bow_n_words, self.device)
        else:
            self.bow_n_words = 0
            self.kf_bow = None
        self.mapper = LocalMapper(self)
        self.loop_closer = LoopCloser(self)
        # Bumped by loop correction / global BA: a mapping result
        # dispatched before a bump carries a stale pose.
        self.map_version = 0

    # ------------------------------------------------------------------
    # public API (reference System.h:84-128)
    # ------------------------------------------------------------------
    def track_stereo(self, img_left, img_right, timestamp: float) -> np.ndarray:
        """Track one rectified stereo pair (8-bit grayscale); returns the
        latest consumed Tcw (one frame behind, see `async_depth`)."""
        with self.timers.time("Tracking total / frame"):
            return self._track_stereo(img_left, img_right, timestamp)

    def _track_stereo(self, img_left, img_right, timestamp: float) -> np.ndarray:
        imgs = torch.from_numpy(
            np.stack([np.asarray(img_left), np.asarray(img_right)])
            .astype(np.uint8)
        ).to(self.device)
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            frame = build_frame_stereo(imgs[0].float(), imgs[1].float(),
                                       self.cam, self.spec, self.scales,
                                       self.line_cap, self.line_cfg)
            self._stereo_initialize(frame, timestamp)
            return self.last_Tcw_np.copy()
        if self.step is None:
            # LOST with no live tracker state (right after load_map): build
            # the frame and go straight to relocalization.
            frame = build_frame_stereo(imgs[0].float(), imgs[1].float(),
                                       self.cam, self.spec, self.scales,
                                       self.line_cap, self.line_cfg)
            step = StepState.fresh(
                frame, torch.from_numpy(self.last_Tcw_np).to(self.device))
            if self.vocab is not None and self.n_kfs > 0:
                self._try_relocalize(step, timestamp)
            self.frame_id += 1
            return self.last_Tcw_np.copy()
        self.map, new_step, stats = pipeline.vo_frame_step(
            imgs, self.map, self.step, self.th_depth_m, self.ref_kf,
            self.cam, self.spec, self.scales,
            m_local=self.settings.local_window,
            scale_factor=self.settings.scale_factor,
            n_levels=self.settings.n_levels,
            line_capacity=self.line_cap, line_cfg=self.line_cfg,
            loc_mode=self.localization_only,
        )
        return self._enqueue_step(new_step, stats, timestamp)

    def track_rgbd(self, img, depth, timestamp: float) -> np.ndarray:
        """Track one registered RGB-D pair: an 8-bit grayscale image and a
        depth map in the sensor's units (`depth_map_factor` scales it to
        metres); returns the latest consumed Tcw (one frame behind, see
        `async_depth`). As in the JAX package there is no branch for LOST
        without tracker state (ROADMAP C)."""
        with self.timers.time("Tracking total / frame"):
            return self._track_rgbd(img, depth, timestamp)

    def _track_rgbd(self, img, depth, timestamp: float) -> np.ndarray:
        image = torch.from_numpy(np.asarray(img).astype(np.uint8)).to(self.device)
        depth_map = torch.from_numpy(np.asarray(depth, np.float32)).to(self.device)
        st = self.settings
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED):
            frame = build_frame_rgbd(image.float(), depth_map, self.cam, self.spec,
                                     st.depth_map_factor, self.line_cap,
                                     self.line_cfg)
            self._stereo_initialize(frame, timestamp)
            return self.last_Tcw_np.copy()
        self.map, new_step, stats = pipeline.vo_frame_step_rgbd(
            image, depth_map, self.map, self.step, self.th_depth_m, self.ref_kf,
            self.cam, self.spec, self.scales, m_local=st.local_window,
            scale_factor=st.scale_factor, n_levels=st.n_levels,
            depth_factor=st.depth_map_factor, line_capacity=self.line_cap,
            line_cfg=self.line_cfg, loc_mode=self.localization_only,
        )
        return self._enqueue_step(new_step, stats, timestamp)

    def track_mono(self, img, timestamp: float) -> np.ndarray:
        """Track one monocular image (8-bit grayscale); returns the latest
        consumed Tcw (one frame behind after initialization, see
        `async_depth`; identity until the two-view bootstrap succeeds)."""
        with self.timers.time("Tracking total / frame"):
            image = torch.from_numpy(np.asarray(img).astype(np.uint8)).to(self.device)
            return mono.track_mono_impl(self, image, timestamp)

    def upload_batch(self, pairs) -> torch.Tensor:
        """Stage a batch of stereo pairs on the device ([B,2,H,W] uint8)
        for `track_stereo_batch`; on a GPU from pinned memory without
        waiting for the copy."""
        return self._stage(np.stack([np.stack([np.asarray(l), np.asarray(r)])
                                     for l, r in pairs]))

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.uint8)))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def track_stereo_batch(self, pairs, timestamps) -> np.ndarray:
        """Track a batch of stereo pairs (a list, or a tensor staged by
        `upload_batch`) with one `pipeline.vo_batch_step`; returns the last
        consumed Tcw. Before the map exists the first frame bootstraps
        through `track_stereo`. Keyframe and relocalization decisions run
        between batches, on each batch's final frame."""
        t0 = time.perf_counter()
        B = len(pairs)
        if self.state in (TrackingState.NO_IMAGES_YET,
                          TrackingState.NOT_INITIALIZED) or self.step is None:
            first = ((pairs[0, 0].cpu().numpy(), pairs[0, 1].cpu().numpy())
                     if isinstance(pairs, torch.Tensor) else pairs[0])
            out = self.track_stereo(first[0], first[1], timestamps[0])
            if B > 1:
                return self.track_stereo_batch(pairs[1:], timestamps[1:])
            return out
        imgs = pairs if isinstance(pairs, torch.Tensor) else self.upload_batch(pairs)
        self.map, self.step, stats = pipeline.vo_batch_step(
            imgs, self.map, self.step, self.th_depth_m, self.ref_kf,
            self.cam, self.spec, self.scales,
            m_local=self.settings.local_window,
            scale_factor=self.settings.scale_factor,
            n_levels=self.settings.n_levels,
            line_capacity=self.line_cap, line_cfg=self.line_cfg,
            loc_mode=self.localization_only,
        )
        return self._dispatched_batch(stats, timestamps, imgs, t0)

    def track_mono_batch(self, images, timestamps) -> np.ndarray:
        """Track a batch of monocular images (a list, or a staged [B,H,W]
        uint8 tensor) with one `pipeline.vo_batch_step_mono`; frames before
        the map's two-view initialization (or while LOST) go one at a time
        through `track_mono`."""
        t0 = time.perf_counter()
        B = len(images)
        if self.state != TrackingState.OK or self.step is None:
            first = (images[0].cpu().numpy() if isinstance(images, torch.Tensor)
                     else images[0])
            out = self.track_mono(first, timestamps[0])
            if B > 1:
                return self.track_mono_batch(images[1:], timestamps[1:])
            return out
        imgs = (images if isinstance(images, torch.Tensor)
                else self._stage(np.stack([np.asarray(i) for i in images])))
        st = self.settings
        self.map, self.step, stats = pipeline.vo_batch_step_mono(
            imgs, self.map, self.step, self.th_depth_m, self.ref_kf,
            self.cam, self.spec, self.scales, m_local=st.local_window,
            scale_factor=st.scale_factor, n_levels=st.n_levels,
            line_capacity=self.line_cap, undistort=st.has_distortion,
            line_cfg=self.line_cfg, loc_mode=self.localization_only,
        )
        return self._dispatched_batch(stats, timestamps, imgs, t0)

    def _dispatched_batch(self, stats, timestamps, imgs, t0: float) -> np.ndarray:
        B = len(timestamps)
        fid0 = self.frame_id      # row b of this batch is frame fid0 + b + 1
        self.frame_id += B
        self._queue_batch_stats(stats, list(timestamps), self.step, imgs, fid0)
        self.timers.add("Tracking total / frame",
                        (time.perf_counter() - t0) * 1e3 / max(B, 1))
        return self.last_Tcw_np.copy()

    def activate_localization_mode(self):
        """Track against the map without inserting keyframes (reference
        System::ActivateLocalizationMode)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def get_tracking_state(self) -> TrackingState:
        self.drain()
        return self.state

    def health(self) -> dict:
        """Solver-guard counters so far. A healthy run has
        mapping_state_revert == 0 and loop_guarded == 0; mapping_guarded is
        transient and only its rate is bounded; mapping_lm_singular is
        benign; loop_verify_guarded counts degenerate Sim3 verifications
        (rejected by the count gates)."""
        return {
            "mapping_guarded": self.mapper.n_guarded,
            "mapping_state_revert": self.mapper.n_state_revert,
            "mapping_lm_singular": self.mapper.n_lm_singular,
            "loop_guarded": self.loop_closer.n_guarded,
            "loop_verify_guarded": self.loop_closer.n_guarded_verify,
            "mapping_steps": self.mapper.n_steps,
            "loop_corrections": self.loop_closer.corrections,
            "verified_loops": len(self.loop_closer.verified_loops),
        }

    def map_changed(self) -> bool:
        """Whether a mapping step or a loop correction has changed the map
        (reference System::MapChanged)."""
        return self.mapper.big_change_idx > 0

    def reset(self):
        self._reset_runtime()
        self.state = TrackingState.NO_IMAGES_YET

    def shutdown(self):
        """Consume every in-flight frame and apply the mapper's pending
        result (reference System::Shutdown)."""
        self.drain()

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
        """Consume all in-flight batch and frame stats (called before any
        state or trajectory query)."""
        while self._pending_batches:
            self._consume_batch_stats(*self._pending_batches.popleft())
        while self._pending:
            self._process_one()
        self.mapper.flush()   # apply any pending post-BA pose and culls

    # ------------------------------------------------------------------
    # batch control flow (stats consumed at once, or `batch_defer_depth`
    # batches late with `batch_defer_stats`)
    # ------------------------------------------------------------------
    def _queue_batch_stats(self, stats, timestamps, step_snap, imgs, fid0):
        """Start the copy of a dispatched batch's stats to the host. With
        batch_defer_stats the batch waits in `_pending_batches` and the
        oldest is consumed once more than `batch_defer_depth` are in
        flight; without it, it is consumed now."""
        fetch = _StatsFetch(stats)
        if not self.settings.batch_defer_stats:
            self._consume_batch_stats(fetch, timestamps, step_snap, imgs, fid0)
            return
        self._pending_batches.append((fetch, timestamps, step_snap, imgs, fid0))
        depth = max(1, int(self.settings.batch_defer_depth))
        while len(self._pending_batches) > depth:
            self._consume_batch_stats(*self._pending_batches.popleft())

    def _consume_batch_stats(self, fetch: _StatsFetch, timestamps, step_snap,
                             imgs: torch.Tensor, fid0: int):
        """Host bookkeeping for one tracked batch: per-frame logs, LOST
        handling, and the keyframe and relocalization decisions on the
        batch's final frame (`step_snap` holds its FrameData).

        A loss that lasts to the batch's final frame replays the staged
        images (`imgs`) one frame at a time from the first lost frame
        through the per-frame path, which attempts relocalization on
        every lost frame (reference Tracking.cc:2895); newer batches
        already dispatched from the diverged state are dropped and
        replayed too. A dip that heals by the final frame is not
        replayed: those rows log the last good pose, as a lost frame of
        the per-frame path does. Batch rows get no reference-keyframe
        fallback (the reference's batch consumer has none)."""
        stats = fetch.get()
        B = stats.shape[0]
        self._resolve_kf_out()
        lost_rows = np.array([
            track_lost(int(stats[b, pipeline.S_N_IN]),
                       int(stats[b, pipeline.S_N_LN_IN]),
                       self.settings.using_line,
                       fid0 + b + 1 < self._last_reloc_fid + int(self.settings.fps))
            for b in range(B)
        ])
        if (lost_rows[-1] and self.vocab is not None and self.n_kfs > 0
                and not self._batch_recovering):
            b0 = int(np.argmax(lost_rows))
            self._consume_rows(stats, timestamps, 0, b0, fid0)
            self._recover_batch_suffix(imgs, timestamps, b0)
            return
        self._consume_rows(stats, timestamps, 0, B, fid0)
        if (self.state == TrackingState.LOST and self.vocab is not None
                and self.n_kfs > 0):
            # a loss inside a replay: relocalize the batch's final frame,
            # as the per-frame path does each frame
            self.trajectory.pop()
            if self._try_relocalize(step_snap, timestamps[-1], fid=fid0 + B):
                self._frames_lost = 0
            else:
                self._log_frame(timestamps[-1], self.last_Tcw_np, lost=True)
        # the keyframe policy on the batch's final frame
        if (self.state == TrackingState.OK and not self.localization_only
                and self._need_new_keyframe(stats[-1],
                                            int(stats[-1][pipeline.S_N_IN]))):
            self.trajectory.pop()   # _create_keyframe's path logs it again
            self.frames_since_kf -= 1
            self._create_keyframe(step_snap, self.last_Tcw_np, timestamps[-1])
            self._log_frame(timestamps[-1], self.last_Tcw_np, lost=False)
            self.frames_since_kf = 0

    def _consume_rows(self, stats, timestamps, lo: int, hi: int, fid0: int):
        """Per-frame bookkeeping for rows [lo, hi) of a batch's stats; row
        b is frame fid0 + b + 1."""
        for b in range(lo, hi):
            row = stats[b]
            n_in = int(row[pipeline.S_N_IN])
            Tcw_np = row[pipeline.S_POSE].reshape(4, 4).astype(np.float32)
            recent = fid0 + b + 1 < self._last_reloc_fid + int(self.settings.fps)
            lost = track_lost(n_in, int(row[pipeline.S_N_LN_IN]),
                              self.settings.using_line, recent)
            if lost:
                self.state = TrackingState.LOST
                self._frames_lost += 1
            else:
                self.state = TrackingState.OK
                self._frames_lost = 0
                self.last_Tcw_np = Tcw_np
            # a lost frame logs the last good pose, as the per-frame path
            self._log_frame(timestamps[b], self.last_Tcw_np, lost=lost)
            self.frames_since_kf += 1

    def _recover_batch_suffix(self, imgs, timestamps, b0: int):
        """Replay frames [b0:] of a lost batch, and every newer batch still
        pending (dispatched from the diverged state; its results are
        dropped), through the per-frame path. `imgs`: the staged
        [B,2,H,W] stereo pairs or [B,H,W] mono images."""
        self._batch_recovering = True
        try:
            segments = [(imgs, timestamps, b0)]
            while self._pending_batches:
                _, ts2, _, imgs2, _ = self._pending_batches.popleft()
                segments.append((imgs2, ts2, 0))
            self.frame_id -= sum(len(ts) - lo for _, ts, lo in segments)
            for arr, ts_list, lo in segments:
                host = arr.cpu().numpy()
                for b in range(lo, len(ts_list)):
                    if host.ndim == 4:
                        self.track_stereo(host[b, 0], host[b, 1], ts_list[b])
                    else:
                        self.track_mono(host[b], ts_list[b])
        finally:
            self._batch_recovering = False

    def _process_one(self):
        stats_dev, ts, step_state, fid = self._pending.popleft()
        stats = stats_dev.cpu().numpy()
        self._resolve_kf_out()
        n_mm = int(stats[pipeline.S_N_MM])
        n_in = int(stats[pipeline.S_N_IN])
        n_ln_in = int(stats[pipeline.S_N_LN_IN])
        recent_reloc = fid < self._last_reloc_fid + int(self.settings.fps)
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

        if track_lost(n_in, n_ln_in, self.settings.using_line, recent_reloc):
            # Relocalization (reference Tracking.cc:2895): BoW candidates ->
            # PnP RANSAC -> GN refine, accepted at >= reloc_min_inliers.
            if self.vocab is not None and self.n_kfs > 0:
                if self._try_relocalize(step_state, ts):
                    return
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
        if not self.localization_only and self._need_new_keyframe(stats, n_in):
            self._create_keyframe(step_state, Tcw_np, ts)
        else:
            self.frames_since_kf += 1
        self.last_Tcw_np = Tcw_np
        self._log_frame(ts, Tcw_np, lost=False)

    def _register_kf_bow(self, kf: int, frame: FrameData):
        """Compute and store the keyframe's BoW row (KeyFrameDatabase::add,
        reference src/KeyFrameDatabase.cc:40)."""
        if self.vocab is None:
            return
        v = self.vocab
        V.update_bow_row(self.kf_bow.ids, self.kf_bow.vals, v.level_desc,
                         v.weights, v.k, v.depth, frame.feat.desc,
                         frame.feat.valid, kf)

    def _try_relocalize(self, step_state: StepState, ts: float,
                        fid: int | None = None) -> bool:
        """Try the three best BoW candidates in turn; on the first attempt
        with >= reloc_min_inliers, adopt its pose and associations. `fid`:
        the frame's id where it is not the newest (a batch's final frame
        consumed late)."""
        frame = step_state.frame
        v = self.vocab
        query = V.query_bow(v.level_desc, v.weights, v.k, v.depth,
                            frame.feat.desc, frame.feat.valid)
        kfs = self.map.kfs
        scores = reloc.reloc_scores(
            self.kf_bow.ids, self.kf_bow.vals, kfs.valid, query,
            torch.zeros_like(kfs.valid))
        # Ties go to the higher index, as the reference's host argsort.
        order = np.argsort(scores.cpu().numpy())[::-1][:3]
        gen = torch.Generator(device=self.device)
        for c in order:
            c = int(c)
            if c >= self.n_kfs:
                continue
            lm = kfs.lm_idx[c]
            ll = kfs.ll_idx[c]
            gen.manual_seed(self.frame_id)   # one seed per frame, as the reference
            Tcw, n_in, lm_gid, ll_gid = reloc.reloc_attempt(
                self.cam, frame, kfs.desc[c], kfs.fvalid[c], lm,
                self.map.pts.xyz[lm.clamp(min=0).long()], kfs.ldesc[c], ll,
                self.map.lns.xyz[ll.clamp(min=0).long()], generator=gen)
            if int(n_in) < self.settings.reloc_min_inliers:
                continue
            Tcw_np = Tcw.cpu().numpy().astype(np.float32)
            lsafe = ll_gid.clamp(min=0).long()
            corrected = step_state._replace(
                lm_gid=lm_gid,
                lm_xyz=self.map.pts.xyz[lm_gid.clamp(min=0).long()],
                Tcw=Tcw,
                velocity=torch.eye(4, device=self.device),
                ll_gid=ll_gid,
                ll_xyz3=self.map.lns.xyz[lsafe],
                ll_len=self.map.lns.avg_len2d[lsafe],
            )
            # Don't rewind the live tracker if a newer frame was already
            # dispatched; the relocalized pose still enters the log.
            if step_state is self.step:
                self.step = corrected
            self.state = TrackingState.OK
            self._frames_lost = 0
            self._last_reloc_fid = fid if fid is not None else self.frame_id
            self.ref_kf = c
            self.last_Tcw_np = Tcw_np
            self._log_frame(ts, Tcw_np, lost=False)
            return True
        return False

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
        self._register_kf_bow(kf, frame)
        self.mapper.on_keyframe(kf)

    def _need_new_keyframe(self, stats: np.ndarray, n_in: int) -> bool:
        """Reference Tracking::NeedNewKeyFrame(Both) (src/Tracking.cc:
        2181-2336): (c1a || c1b || c1c) && c2."""
        if self.n_kfs >= self.settings.max_keyframes - 1:
            return False
        if self.settings.force_kf_every > 0:
            return self.frames_since_kf >= self.settings.force_kf_every
        max_frames = int(self.settings.fps)
        is_stereo = self.has_depth
        n_tracked_close = int(stats[pipeline.S_CLOSE_TRACKED])
        n_untracked_close = int(stats[pipeline.S_CLOSE_UNTRACKED])
        need_close = is_stereo and (n_tracked_close < 100) and (n_untracked_close > 70)
        if self.frames_since_kf < self.settings.min_kf_gap:
            return False
        ref_matches = max(int(stats[pipeline.S_REF_MATCHES]), 1)
        # thRefRatio: 0.4 with one keyframe, 0.75 stereo, 0.9 monocular
        th_ratio = 0.4 if self.n_kfs < 2 else (0.75 if is_stereo else 0.9)
        c1a = self.frames_since_kf >= max_frames
        c1b = self.frames_since_kf >= self.settings.min_kf_gap
        c1c = is_stereo and ((n_in < ref_matches * 0.25) or need_close)
        if self.settings.using_line:
            # NeedNewKeyFrameBoth c2 (src/Tracking.cc:2307-2308): either
            # modality decaying against its reference keyframe; the line
            # term is false with no reference map lines (0 < 0)
            n_ln_in = int(stats[pipeline.S_N_LN_IN])
            ref_ln = int(stats[pipeline.S_REF_LN_MATCHES])
            c2 = (((n_in < ref_matches * 0.9) or (n_ln_in < ref_ln * 0.8)
                   or need_close)
                  and (n_in > 15 or n_ln_in > 10 or n_in + n_ln_in >= 12))
        else:
            c2 = ((n_in < ref_matches * th_ratio) or need_close) and n_in > 15
        return (c1a or c1b or c1c) and c2

    def _create_keyframe(self, step_state: StepState, Tcw_np: np.ndarray,
                         ts: float):
        with self.timers.time("KeyFrame insertion"):
            self.map, new_state, out = pipeline.add_keyframe_step(
                self.map, step_state, self.frame_id, ts, self.th_depth_m, self.cam,
                scale_factor=self.settings.scale_factor,
                n_levels=self.settings.n_levels, max_new=200,
                is_stereo=self.has_depth,
            )
            kf = self.n_kfs  # keyframes are appended densely
            self.n_kfs += 1
            self.ref_kf = kf
            self.frames_since_kf = 0
            self.kf_pose_host[kf] = Tcw_np.copy()
            if step_state is self.step:
                self.step = new_state
            self._pending_kf_out = out
            self._register_kf_bow(kf, step_state.frame)
        with self.timers.time("Mapping total / keyframe"):
            self.mapper.on_keyframe(kf)
        if self.settings.enable_loop_closing:
            with self.timers.time("Loop detection / keyframe"):
                self.loop_closer.on_keyframe(kf)

    def _resolve_kf_out(self):
        if self._pending_kf_out is not None:
            self.n_pts = int(self._pending_kf_out[2])
            self._pending_kf_out = None

    def _log_frame(self, ts: float, Tcw_np: np.ndarray, lost: bool):
        Trw = self.kf_pose_host.get(self.ref_kf, np.eye(4, dtype=np.float32))
        Tcr = Tcw_np @ np.linalg.inv(Trw)
        self.trajectory.append(
            _TrajEntry(ts, Tcr, self.ref_kf, lost, Tcw_np.copy()))

    def _on_mapping_result(self, kf: int, pose: np.ndarray | None, culled):
        """Host bookkeeping after a mapping step (reference
        KeyFrame::SetBadFlag mTcp + System.cc:369-374, applied eagerly):
        refresh the stepped keyframe's host pose with its post-BA value
        (None: stale, skipped), and re-root trajectory entries whose
        reference keyframe was culled onto the anchor `kf`:
        Tcr' = Tcr @ Tcp, ref' = kf."""
        if pose is not None:
            self.kf_pose_host[kf] = pose.astype(np.float32)
        for cid, Tcp in culled:
            if cid == kf:
                continue
            Tcp = Tcp.astype(np.float32)
            for e in self.trajectory:
                if e.ref_kf == cid:
                    e.Tcr = (e.Tcr @ Tcp).astype(np.float32)
                    e.ref_kf = kf
            self.kf_pose_host.pop(cid, None)
            if self.ref_kf == cid:
                self.ref_kf = kf

    def get_tracked_map_points(self) -> np.ndarray:
        """World positions of the landmarks tracked in the current frame
        (reference System::GetTrackedMapPoints), [n, 3]."""
        self.drain()
        if self.step is None:
            return np.zeros((0, 3), np.float32)
        gid = self.step.lm_gid.cpu().numpy()
        return self.step.lm_xyz.cpu().numpy()[gid >= 0]

    def get_tracked_keypoints(self) -> np.ndarray:
        """Keypoints of the current frame, every slot's xy (reference
        System::GetTrackedKeyPointsUn), [N, 2]."""
        self.drain()
        if self.step is None:
            return np.zeros((0, 2), np.float32)
        return self.step.frame.feat.xy.cpu().numpy()

    # ------------------------------------------------------------------
    # trajectory export (reference System.cc:340-540)
    # ------------------------------------------------------------------
    def poses(self) -> np.ndarray:
        """All per-frame camera-to-world poses [F,4,4] (online estimates)."""
        self.drain()
        return np.stack([np.linalg.inv(e.Tcw) for e in self.trajectory])

    def poses_reconstructed(self) -> np.ndarray:
        """Per-frame Twc [F,4,4] reconstructed against the FINAL keyframe
        poses, as the trajectory savers write them: these follow loop
        corrections and global BA."""
        self.drain()
        return np.stack([Twc for _, Twc in self._reconstructed(skip_lost=False)])

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

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only TUM trajectory (reference
        System::SaveKeyFrameTrajectoryTUM, src/System.cc:397-438)."""
        self.drain()
        n = self.n_kfs
        kfs = self.map.kfs
        kf_Tcw = kfs.Tcw[:n].cpu().numpy()
        kf_ts = kfs.ts[:n].cpu().numpy()
        kf_valid = kfs.valid[:n].cpu().numpy()
        with open(path, "w") as f:
            for k in range(n):
                if not kf_valid[k]:
                    continue
                Twc = np.linalg.inv(kf_Tcw[k])
                t = Twc[:3, 3]
                q = _rot_to_quat(Twc[:3, :3])
                f.write(
                    f"{float(kf_ts[k]):.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
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

    def save_trajectory_kitti_mono(self, path: str):
        """The reference's SaveTrajectoryKITTIMono (src/System.cc:492-540,
        added there because its KITTI saver refuses the MONOCULAR sensor).
        The KITTI saver here takes any sensor; monocular poses are up to
        scale, as the reference's."""
        self.save_trajectory_kitti(path)


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


# ----------------------------------------------------------------------
# Map checkpoints in the JAX package's `.npz` layout: `{group}.{field}`
# for the point, line and keyframe tables (descriptors as uint32), the
# counters, and `meta.*` for the host state and the BoW rows.
# ----------------------------------------------------------------------
def save_map(system: System, path: str) -> None:
    """Checkpoint the map and enough tracker state to relocalize into it
    after loading."""
    system.drain()
    m = convert.map_state_to_numpy(system.map)
    d = {f"{g}.{f}": getattr(getattr(m, g), f)
         for g in ("pts", "lns", "kfs") for f in getattr(m, g)._fields}
    d.update(n_pts=m.n_pts, n_lns=m.n_lns, n_kfs=m.n_kfs)
    d["meta.n_kfs_host"] = np.int64(system.n_kfs)
    d["meta.ref_kf"] = np.int64(system.ref_kf)
    if system.kf_bow is not None:
        bow = convert.bow_table_to_numpy(system.kf_bow)
        d["meta.kf_bow_ids"] = bow.ids
        d["meta.kf_bow_vals"] = bow.vals
    np.savez_compressed(path, **d)


def load_map(system: System, path: str) -> None:
    """Restore a checkpoint into a fresh System (same Settings). The
    system starts LOST and relocalizes against the loaded map."""
    z = np.load(path)
    m = system.map
    groups = {g: type(getattr(m, g))(*[z[f"{g}.{f}"]
                                       for f in getattr(m, g)._fields])
              for g in ("pts", "lns", "kfs")}
    system.map = convert.map_state_from_numpy(
        MapState(**groups, n_pts=z["n_pts"], n_lns=z["n_lns"],
                 n_kfs=z["n_kfs"]), system.device)
    system.n_kfs = int(z["meta.n_kfs_host"])
    system.ref_kf = int(z["meta.ref_kf"])
    if system.kf_bow is not None and "meta.kf_bow_ids" in z:
        system.kf_bow = V.BowTable(
            torch.from_numpy(z["meta.kf_bow_ids"]).to(system.device),
            torch.from_numpy(z["meta.kf_bow_vals"]).to(system.device))
    elif system.kf_bow is not None and "meta.kf_bow" in z:
        # Checkpoints from before the sparse table hold the dense [K, W]
        # matrix: compact each row.
        dense = np.asarray(z["meta.kf_bow"])
        K, W = dense.shape
        S = system.kf_bow.ids.shape[1]
        ids = np.full((K, S), W, np.int32)
        vals = np.zeros((K, S), np.float32)
        for k in range(K):
            nz = np.flatnonzero(dense[k])[:S]
            ids[k, : len(nz)] = nz
            vals[k, : len(nz)] = dense[k, nz]
        system.kf_bow = V.BowTable(torch.from_numpy(ids).to(system.device),
                                   torch.from_numpy(vals).to(system.device))
    kf_Tcw = system.map.kfs.Tcw[: system.n_kfs].cpu().numpy()
    for k in range(system.n_kfs):
        system.kf_pose_host[k] = kf_Tcw[k]
    system.state = TrackingState.LOST


System.save_map = save_map
System.load_map = load_map
