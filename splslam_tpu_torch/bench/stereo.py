"""Stereo tracking at KITTI size: the port of bench.py.

Three rows:

- `kitti_stereo_tracking_fps_per_chip` (bench.py:35-117): a 96-frame
  forward leg at 1241x376 (fx 718, baseline 0.54) shuttled into 384
  frames; bench.py:51-65's settings (2000 features, 8 levels, 65,536
  points, 256 keyframes, a 2048-landmark window, mapping off,
  `min_kf_gap=64`, stats deferred at depth 3). Frame 0 bootstraps the
  map, every batch of B = 32 is staged by `upload_batch` before timing,
  and the batches from frame 65 on are timed, each as its synced wall
  over B. The value is 1000 / the median ms a frame.
- `kitti_stereo_tracking_ms_per_frame`: per-frame `track_stereo` at the
  same settings, synced, from frame 10 on, over 170 frames of the same
  shuttle.
- `kitti_stereo_fps_realistic_kf_cadence` (bench.py:120-198, `--full`):
  256 frames with local mapping on, 64 keyframes, `min_kf_gap=8`,
  `force_kf_every=16`, B = 8; the value is 1000 / the whole region's
  ms a frame (every batch and the final drain).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np

from splslam_tpu_torch.bench.common import Bench, cuts, launch_check, summary, watched
from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence, path_length
from splslam_tpu_torch.ops import orb_kernel
from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

SCENE_SEED = 3       # bench.py:46
ATE_GATE = 0.01      # ATE-RMSE as a share of the path (the repo's drift gate)
DT = 0.1


@dataclass(frozen=True)
class Size:
    width: int = 1241
    height: int = 376
    fx: float = 718.0
    baseline: float = 0.54
    n_features: int = 2000
    n_levels: int = 8
    max_points: int = 65536
    max_keyframes: int = 256
    local_window: int = 2048
    leg: int = 96                 # rendered forward leg, shuttled
    n_frames: int = 384           # the batched row
    batch: int = 32
    warmup: int = 65              # batches from this frame on are timed
    per_frame: int = 170          # the per-frame row
    per_frame_skip: int = 10
    realistic_frames: int = 256
    realistic_batch: int = 8
    realistic_keyframes: int = 64
    realistic_min_kf_gap: int = 8
    force_kf_every: int = 16
    realistic_warmup: int = 33    # frames of a throwaway run before the repeats (0: none)
    realistic_trace_batches: int = 2   # the realistic row's traced window
    trace_frames: int = 5         # per-frame calls in the per-frame row's trace
    ate_gate_m: float | None = None   # None: ATE_GATE of the path


FULL = Size()
# the CPU test size (320x240, 600 features, 4 levels, short sequences)
SMALL = Size(width=320, height=240, fx=200.0, baseline=0.12, n_features=600,
             n_levels=4, max_points=8192, max_keyframes=64, local_window=1024,
             leg=12, n_frames=13, batch=4, warmup=8, per_frame=6, per_frame_skip=2,
             realistic_frames=9, realistic_batch=4, realistic_keyframes=32,
             realistic_min_kf_gap=2, force_kf_every=8, realistic_warmup=0,
             realistic_trace_batches=1, trace_frames=1,
             ate_gate_m=0.05)   # tests/test_e2e_stereo.py:43's gate at this size


def settings(K, bf, size: Size = FULL) -> Settings:
    """bench.py:51-65: tracking only, relocalization and loop detection
    at their defaults (on), a 64-frame minimum keyframe gap, each batch's
    stats read three batches late."""
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=size.width, height=size.height,
        n_features=size.n_features, n_levels=size.n_levels, th_depth=35.0,
        fps=10.0, max_points=size.max_points, max_keyframes=size.max_keyframes,
        local_window=size.local_window, enable_local_mapping=False,
        batch_defer_stats=True, batch_defer_depth=3, min_kf_gap=64,
    )


def realistic_settings(K, bf, size: Size = FULL) -> Settings:
    """bench.py:145-153: local mapping on, a keyframe forced every 16
    frames, at most 64 keyframes."""
    return dataclasses.replace(
        settings(K, bf, size), max_keyframes=size.realistic_keyframes,
        enable_local_mapping=True, min_kf_gap=size.realistic_min_kf_gap,
        force_kf_every=size.force_kf_every)


class Shuttle:
    """bench.py:40-50: the forward leg played forward and back, so the
    camera stays inside the scene for any length."""

    def __init__(self, size: Size, seed: int):
        self.K, self.bf, leg, gt = make_stereo_sequence(
            n_frames=size.leg, width=size.width, height=size.height, fx=size.fx,
            baseline=size.baseline, motion="forward", seed=SCENE_SEED + seed)
        self.cycle = leg + leg[-2:0:-1]
        self.gt_cycle = np.concatenate([gt, gt[-2:0:-1]])

    def frames(self, lo: int, hi: int):
        return [self.cycle[i % len(self.cycle)] for i in range(lo, hi)]

    def gt(self, idx) -> np.ndarray:
        return self.gt_cycle[np.asarray(idx) % len(self.cycle)]


def _accuracy(sysm: System, shuttle: Shuttle, size: Size) -> dict:
    """ATE-RMSE of every logged frame (its timestamp gives its index)
    against the shuttle's ground truth, its gate, the frames lost and the
    state once every batch is consumed."""
    state = sysm.get_tracking_state().name
    idx = [int(round(e.ts / DT)) for e in sysm.trajectory]
    gt = shuttle.gt(idx)
    ate = ate_rmse(sysm.poses(), gt)
    path = path_length(gt)
    gate = ATE_GATE * path if size.ate_gate_m is None else size.ate_gate_m
    return {"ate": ate, "path": path, "ate_share": ate / max(path, 1e-12),
            "ate_gate": gate, "ate_ok": ate <= gate,
            "lost": int(sum(e.lost for e in sysm.trajectory)), "state": state}


def _ate_check(size: Size) -> str:
    return (f"ATE-RMSE <= {ATE_GATE:.0%} of the path" if size.ate_gate_m is None
            else f"ATE-RMSE <= {size.ate_gate_m} m")


def _batched_repeat(b: Bench, st: Settings, shuttle: Shuttle, n_frames: int, B: int,
                    timed_from: int, chunks_from_zero: bool):
    """One fresh System over `n_frames` of the shuttle in batches of B,
    frame 0 through `track_stereo`. `chunks_from_zero`: bench.py's
    headline chunking (chunk c holds frames cB..cB+B-1, chunk 0 without
    the bootstrap frame); else chunks start at frame 1. Returns (System,
    ms/frame of each timed batch, whole-region ms/frame of the timed
    batches with the final drain)."""
    sysm = watched(b.setup("systems", System, st, Sensor.STEREO, b.device))
    frames = shuttle.frames(0, n_frames)
    # (the frame a chunk's timing is keyed on, its first frame, its end)
    if chunks_from_zero:
        spans = [(s, max(s, 1), min(s + B, n_frames)) for s in range(0, n_frames, B)]
    else:
        spans = [(s, s, min(s + B, n_frames)) for s in range(1, n_frames, B)]
    sysm.track_stereo(*frames[0], 0.0)
    staged = b.setup("staging", lambda: [sysm.upload_batch(frames[lo:hi])
                                         for _, lo, hi in spans])
    b.settle()
    per_batch, t_region, n_timed = [], None, 0
    for (key, lo, hi), imgs in zip(spans, staged):
        timed = key >= timed_from
        if timed and t_region is None:
            b.sync()
            t_region = time.perf_counter()
        _, ms = b.timed(sysm.track_stereo_batch, imgs, [i * DT for i in range(lo, hi)])
        if timed:
            per_batch.append(ms / (hi - lo))
            n_timed += hi - lo
    sysm.get_tracking_state()          # drains the deferred batches
    b.sync()
    region = (time.perf_counter() - t_region) * 1e3 / n_timed if n_timed else None
    return sysm, per_batch, region, n_timed


def fps_row(b: Bench, size: Size, shuttle: Shuttle) -> dict:
    st = settings(shuttle.K, shuttle.bf, size)
    reps, regions, acc, replays, orb = [], [], [], [], []
    for _ in range(b.repeats):
        sysm = None          # free the last repeat's System first
        sysm, per_batch, region, n_timed = _batched_repeat(
            b, st, shuttle, size.n_frames, size.batch, size.warmup, True)
        reps.append(per_batch)
        regions.append(region)
        acc.append(_accuracy(sysm, shuttle, size))
        replays.append(sysm.replays)
        orb.append(launch_check(b, sysm, size.n_frames))
    stats = summary(reps)
    # one batch past the shuttle's end on the last repeat's System, traced
    B = size.batch
    lo = size.n_frames
    imgs = sysm.upload_batch(shuttle.frames(lo, lo + B))
    trace = b.trace(f"one batch of {B} frames ({lo}-{lo + B - 1}) after the last repeat",
                    lambda: sysm.track_stereo_batch(imgs, [i * DT for i in range(lo, lo + B)]),
                    stats["median_ms"], per=B)
    checks = {
        "state OK": all(a["state"] == TrackingState.OK.name for a in acc),
        _ate_check(size): all(a["ate_ok"] for a in acc),
        "0 frames lost": all(a["lost"] == 0 for a in acc),
        "0 lost-batch replays": all(r == 0 for r in replays),
        "one ORB launch a frame built": all(n == e for n, e in orb),
    }
    ms = stats["median_ms"]
    return b.row(
        "kitti_stereo_tracking_fps_per_chip", 1000.0 / ms, "frames/s", checks,
        baseline="kitti_tracking_total", ms=ms, **stats,
        whole_region_ms_per_frame=regions, frames=size.n_frames, batch=size.batch,
        timed_frames_per_repeat=n_timed,
        sample="the synced wall of one timed batch over its B frames",
        accuracy=acc, replays=replays, orb_launches=[n for n, _ in orb], trace=trace)


def per_frame_row(b: Bench, size: Size, shuttle: Shuttle) -> dict:
    st = settings(shuttle.K, shuttle.bf, size)
    reps, acc, orb = [], [], []
    frames = shuttle.frames(0, size.per_frame + size.trace_frames)
    for _ in range(b.repeats):
        sysm = None          # free the last repeat's System first
        sysm = watched(b.setup("systems", System, st, Sensor.STEREO, b.device))
        b.settle()
        times = []
        for i in range(size.per_frame):
            _, ms = b.timed(sysm.track_stereo, *frames[i], i * DT)
            times.append(ms)
        reps.append(times[size.per_frame_skip:])
        acc.append(_accuracy(sysm, shuttle, size))
        orb.append(launch_check(b, sysm, size.per_frame))
    stats = summary(reps)
    n = size.trace_frames

    def window():
        for i in range(size.per_frame, size.per_frame + n):
            sysm.track_stereo(*frames[i], i * DT)

    trace = b.trace(f"{n} per-frame calls (frames {size.per_frame}-"
                    f"{size.per_frame + n - 1}) after the last repeat", window,
                    stats["median_ms"], per=n)
    checks = {
        "state OK": all(a["state"] == TrackingState.OK.name for a in acc),
        _ate_check(size): all(a["ate_ok"] for a in acc),
        "0 frames lost": all(a["lost"] == 0 for a in acc),
        "one ORB launch a frame built": all(n_ == e for n_, e in orb),
    }
    return b.row(
        "kitti_stereo_tracking_ms_per_frame", stats["median_ms"], "ms", checks,
        baseline="kitti_tracking_total", ms=stats["median_ms"], **stats,
        frames=size.per_frame, timed_from_frame=size.per_frame_skip,
        sample="the synced wall of one track_stereo call",
        accuracy=acc, orb_launches=[n_ for n_, _ in orb], trace=trace)


def realistic_row(b: Bench, size: Size, shuttle: Shuttle) -> dict:
    st = realistic_settings(shuttle.K, shuttle.bf, size)
    B = size.realistic_batch
    # warm-up: the mapping step's first calls set up the solver libraries
    warm = size.realistic_warmup
    if warm:
        b.setup("warm-up", lambda: _batched_repeat(b, st, shuttle, warm, B, warm, False))
    reps, regions, acc, health, kfs, orb = [], [], [], [], [], []
    for _ in range(b.repeats):
        sysm = None          # free the last repeat's System first
        sysm, per_batch, region, n_timed = _batched_repeat(
            b, st, shuttle, size.realistic_frames, B, 0, False)
        reps.append(per_batch)
        regions.append(region)
        acc.append(_accuracy(sysm, shuttle, size))
        health.append(sysm.health())
        kfs.append(sysm.n_kfs)
        orb.append(launch_check(b, sysm, size.realistic_frames))
    stats = summary(reps)
    lo, nb = size.realistic_frames, size.realistic_trace_batches
    starts = [lo + k * B for k in range(nb)]
    imgs = [sysm.upload_batch(shuttle.frames(s, s + B)) for s in starts]

    def window():
        for s, im in zip(starts, imgs):
            sysm.track_stereo_batch(im, [i * DT for i in range(s, s + B)])
        sysm.drain()

    trace = b.trace(f"{nb} batches of {B} frames ({lo}-{lo + nb * B - 1}) and the drain, "
                    "after the last repeat", window, float(np.median(regions)), per=nb * B)
    value_ms = float(np.median(regions))
    checks = {
        "state OK": all(a["state"] == TrackingState.OK.name for a in acc),
        _ate_check(size): all(a["ate_ok"] for a in acc),
        "mapping_state_revert 0": all(h["mapping_state_revert"] == 0 for h in health),
        "mapping_guarded <= max(3, steps // 25)": all(
            h["mapping_guarded"] <= max(3, h["mapping_steps"] // 25) for h in health),
        "one ORB launch a frame built": all(n == e for n, e in orb),
    }
    return b.row(
        "kitti_stereo_fps_realistic_kf_cadence", 1000.0 / value_ms, "frames/s", checks,
        baseline="kitti_tracking_total", ms=value_ms,
        whole_region_ms_per_frame=regions,
        value_from="1000 / the median over repeats of the whole region (every batch "
                   "and the final drain) over its frames",
        per_batch=stats, frames=size.realistic_frames, batch=B,
        n_keyframes=kfs, mapping_steps=[h["mapping_steps"] for h in health],
        health=health, accuracy=acc, orb_launches=[n for n, _ in orb], trace=trace)


def run(b: Bench, size: Size = FULL) -> list[dict]:
    b.reduced = cuts(size, FULL)
    shuttle = b.setup("scene", Shuttle, size, b.seed)
    if b.cuda:
        b.setup("kernel build", orb_kernel.build)
    return [fps_row(b, size, shuttle), per_frame_row(b, size, shuttle),
            realistic_row(b, size, shuttle)]
