"""The closed loop every cell runs: one camera, one caller that hands over
the next frame when the last call has returned.

A configuration names its sensor (`SENSORS`: the views a frame renders,
and whether it carries depth); a traffic mix names the entry (one of the
System's public entries, `ENTRIES`), the scene and its replay, the System
switches of the run, the warm-up, and how many calls of a traced run the
profiler covers. Rendering, staging and warm-up are set-up; the window
holds only tracking calls.
Each call's wall runs from its start to a `torch.cuda.synchronize()`
after it returns, so it holds the call's device work. A batched window
ends with the deferred stats drained.

The window runs with the garbage collector's set-up objects frozen, and
keeps on the device only the frames its comparison samples (drawn from
the seed as the calls come).
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from harness import render
from harness import scene as S
from harness import trace as T

CALL_SPAN = "benchmark.call"     # the profiler's label of each traced call


@dataclass(frozen=True)
class SensorKind:
    member: str                      # the port's `Sensor` member
    views: Callable                  # (Twc, published keys) -> the poses a frame renders
    depth: bool                      # whether a frame carries its depth image


# A configuration's "sensor", by name.
SENSORS = {
    "stereo": SensorKind(
        "STEREO", lambda Twc, y: [Twc, S.right_pose(Twc, y["Camera.bf"] / y["Camera.fx"])],
        False),
    "monocular": SensorKind("MONOCULAR", lambda Twc, y: [Twc], False),
    "rgbd": SensorKind("RGBD", lambda Twc, y: [Twc], True),
}

# The System's public entries, by the name a traffic mix gives. A frame
# entry takes a frame's inputs (its views, then an RGB-D frame's depth) and
# its timestamp. A batch entry takes B frames' views staged on the device as
# one uint8 tensor ([B, V, H, W], or [B, H, W] for one view) and their
# timestamps; its value is the frame entry that bootstraps the map.
ENTRIES = {"track_stereo": None, "track_mono": None, "track_rgbd": None,
           "track_stereo_batch": "track_stereo", "track_mono_batch": "track_mono"}


@dataclass
class Scene:
    K: np.ndarray
    images: np.ndarray    # uint8 [F, V, H, W]: each rendered frame's views
    poses: np.ndarray     # [F, 4, 4] the camera-to-world pose of each
    order: np.ndarray     # the replay order of the rendered frames
    fps: float
    depth: np.ndarray | None = None   # float32 [F, H, W] in the sensor's units, or None

    def index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def views(self, i: int) -> np.ndarray:
        return self.images[self.index(i)]

    def inputs(self, i: int) -> tuple:
        """What a frame entry takes for frame i before its timestamp."""
        k = self.index(i)
        return tuple(self.images[k]) + (() if self.depth is None else (self.depth[k],))

    def gt(self, i: int) -> np.ndarray:
        return self.poses[self.index(i)]

    def ts(self, i: int) -> float:
        return i / self.fps

    def frame_of(self, ts: float) -> int:
        return int(round(ts * self.fps))


def build_scene(cell, seed: int) -> Scene:
    """The cell's frames, rendered from `seed` at its configuration's
    published intrinsics and distortion, with the views (and depth) its
    sensor takes."""
    y, sc = cell.yaml, cell.traffic["scene"]
    kind = SENSORS[cell.sensor]
    K = S.make_K(y["Camera.fx"], y["Camera.fy"], y["Camera.cx"], y["Camera.cy"])
    H, W = int(y["Camera.height"]), int(y["Camera.width"])
    dist = np.array([y.get(f"Camera.{k}", 0.0) for k in ("k1", "k2", "p1", "p2", "k3")])
    tex = S.TEXTURES[sc["texture"]](seed=seed)
    poses = S.camera_path(sc["motion"], sc["frames"], osc_amp=sc.get("osc_amp", 0.5),
                          period=sc.get("period"))
    # an RGB-D frame's depth in the sensor's units: metres / the System's factor
    depth_scale = (1.0 / cell.settings_fields().get("depth_map_factor", 1.0) if kind.depth
                   else None)
    images, depth = render.render_frames(tex, K, [kind.views(Twc, y) for Twc in poses], H, W,
                                         dist, depth_scale)
    order = S.shuttle(poses) if sc["loop"] == "shuttle" else np.arange(len(poses))
    return Scene(K, images, poses, order, float(y["Camera.fps"]), depth)


@dataclass
class Call:
    frame: int        # the call's last frame
    n_frames: int     # frames it tracked
    ms: float         # its synced wall
    kf_grew: bool     # whether System.n_kfs grew inside it
    traced: bool      # whether the profiler was on


@dataclass
class Window:
    calls: list = field(default_factory=list)
    seconds: float = 0.0             # start to the last synced end (and drain)
    trace: T.Trace | None = None
    n_kfs0: int = 0                  # keyframes when the window opened
    mapping_ms: list = field(default_factory=list)   # host ms of its mapping steps
    mapping_traced: tuple = (0, 0)   # [lo, hi): those that ran under the profiler
    host: dict = field(default_factory=dict)         # what the machine's CPUs did meanwhile

    @property
    def frames(self) -> int:
        return sum(c.n_frames for c in self.calls)

    def first_frame(self) -> int:
        return self.calls[0].frame - self.calls[0].n_frames + 1


class Reservoir:
    """`n` of the calls seen so far, each kept with equal chance (Algorithm
    R), the draws from `seed`: what the comparison samples, without
    holding every call's frame on the device."""

    def __init__(self, n: int, seed: int):
        self.n, self.seen, self.items = n, 0, []
        self.rng = np.random.default_rng([seed, 7])

    def offer(self, item) -> None:
        if self.seen < self.n:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.n:
                self.items[j] = item
        self.seen += 1


def cpu_jiffies() -> list[int]:
    """The machine's CPU time by kind (/proc/stat's first line), or []."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return []


def host_share(before: list[int], after: list[int]) -> dict:
    """The share of the machine's CPU time that was stolen by other guests
    (/proc/stat's eighth column) and that was idle, between two readings."""
    d = [b - a for a, b in zip(before, after)]
    if len(d) < 8 or sum(d) <= 0:
        return {}
    return {"steal": d[7] / sum(d), "idle": d[3] / sum(d)}


@contextlib.contextmanager
def steady():
    """Set-up's objects frozen out of the collector's reach until the
    block ends."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


class Loop:
    """One System of the port driven through the cell's entry."""

    def __init__(self, cell, scene: Scene, device, seed: int = 0):
        from splslam_tpu_torch.slam.system import Sensor, Settings, System

        self.cell, self.scene = cell, scene
        self.device = torch.device(device)
        self.entry = cell.traffic["entry"]
        if self.entry not in ENTRIES:
            raise ValueError(f"unknown entry {self.entry!r}")
        self.batch = int(cell.traffic.get("batch", 1))
        self.sys = System(Settings(**cell.settings_fields()),
                          Sensor[SENSORS[cell.sensor].member], self.device)
        self.next = 0
        self.sample = Reservoir(int(cell.traffic.get("sample_frames", 6)), seed)
        self.traced_valid: list = []    # the keypoint masks of the traced calls' frames
        self.staged: dict = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, entry: str | None = None) -> tuple[int, int]:
        """Hand over the next frame (or batch) to `entry`, by default the
        traffic's; (its last frame, frames)."""
        entry = entry or self.entry
        i, s, sc = self.next, self.sys, self.scene
        if ENTRIES[entry] is None:
            getattr(s, entry)(*sc.inputs(i), sc.ts(i))
            n = 1
        else:
            n = self.batch
            getattr(s, entry)(self.staged[i % len(sc.order)], [sc.ts(j) for j in range(i, i + n)])
        self.next += n
        return i + n - 1, n

    def _stage(self, i: int) -> torch.Tensor:
        """Frames i to i + B - 1 as a batch entry takes them, copied to the
        device from pinned memory without waiting."""
        sc = self.scene
        views = np.stack([sc.views(j) for j in range(i, i + self.batch)])
        t = torch.from_numpy(np.ascontiguousarray(views[:, 0] if views.shape[1] == 1 else views))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @property
    def initialized(self) -> bool:
        """Whether the System has made its map (a monocular one needs a
        two-view initialization)."""
        from splslam_tpu_torch.slam.system import TrackingState

        return self.sys.state not in (TrackingState.NO_IMAGES_YET,
                                      TrackingState.NOT_INITIALIZED)

    def warm_up(self) -> None:
        """The set-up the traffic needs before the window: the first
        frames (the map, its first keyframes and mapping steps), or, for a
        batch entry, the frames its frame entry needs to make the map, the
        staged batches and the warm-up batches."""
        t = self.cell.traffic
        s = self.sys
        bootstrap = ENTRIES[self.entry]
        if bootstrap is not None:
            n, B = len(self.scene.order), self.batch
            if n % B:
                raise ValueError(f"a replay of {n} frames is not whole batches of {B}")
            while not self.initialized and self.next < n:
                self._call(bootstrap)
            for k in range(n // B):
                i = self.next + k * B
                self.staged[i % n] = self._stage(i)
            for _ in range(int(t.get("warmup_batches", 0))):
                self._call()
            s.drain()
        for _ in range(int(t.get("warmup_frames", 0))):
            self._call()
        self.sync()

    def _mapping_steps(self) -> int:
        return len(self.sys.timers.samples.get("Mapping total / keyframe", []))

    def window(self, seconds: float, trace_calls: int = 0) -> Window:
        """Calls until `seconds` have passed. With `trace_calls`, the first
        that many calls to start after half the window run under one
        torch.profiler, each inside a span of its own, and the window
        lasts until they have run; the calls before and after them are
        the untraced ones that host-clock metrics read."""
        from torch.profiler import ProfilerActivity, profile, record_function

        s = self.sys
        w = Window(n_kfs0=s.n_kfs)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = stopped = None
        mapping0 = self._mapping_steps()
        sync_each = bool(self.cell.traffic.get("sync_each_call", True))
        self.sync()
        with steady():
            jiffies, thread0 = cpu_jiffies(), time.thread_time()
            t0 = time.perf_counter()
            while True:
                if trace_calls and prof is None and stopped is None \
                        and time.perf_counter() - t0 >= seconds / 2:
                    prof = profile(activities=acts)
                    prof.start()        # the profiler's own start-up stays outside every call
                    traced_from = len(w.calls)
                    w.mapping_traced = (self._mapping_steps() - mapping0,) * 2
                kfs = s.n_kfs
                traced = prof is not None
                a = time.perf_counter()
                with record_function(CALL_SPAN) if traced else contextlib.nullcontext():
                    frame, n = self._call()
                    if sync_each or traced:
                        self.sync()
                b = time.perf_counter()
                w.calls.append(Call(frame, n, (b - a) * 1e3, s.n_kfs > kfs, traced))
                self.sample.offer((frame, s.step.frame))
                if traced:
                    self.traced_valid.append(s.step.frame.feat.valid)
                    if len(w.calls) - traced_from == trace_calls:
                        prof.stop()
                        w.mapping_traced = (w.mapping_traced[0], self._mapping_steps() - mapping0)
                        stopped, prof = prof, None
                if time.perf_counter() - t0 >= seconds and (not trace_calls or stopped):
                    break
            s.drain()
            self.sync()
            w.seconds = time.perf_counter() - t0 if not sync_each else b - t0
            w.host = host_share(jiffies, cpu_jiffies())
            w.host["caller_cpu"] = (time.thread_time() - thread0) / (time.perf_counter() - t0)
        if stopped is not None:
            w.trace = T.Trace.read(stopped, CALL_SPAN)
            if len(w.trace.calls) != trace_calls:
                raise RuntimeError(f"the profiler kept {len(w.trace.calls)} of {trace_calls} "
                                   "traced calls")
        w.mapping_ms = s.timers.samples.get("Mapping total / keyframe", [])[mapping0:]
        return w
