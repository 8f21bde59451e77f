"""Monocular point+line tracking at TUM size: the port of bench_mono.py.

The scene is bench_mono.py:55-80's: 640x480, fx 520, a smooth closed
lateral oscillation (amplitude 0.5, seed 4) over the grid texture, 120
frames; the settings are bench_mono.py:85-92's (1000 features, 8 levels,
128 line slots, mapping off, `min_kf_gap=20`, stats deferred at depth
3). Each pass tracks frame by frame until the two-view initialization,
stages the rest in batches of B = 8, and times each batch (its synced
wall over its frames).

- `tum_mono_line_tracking_ms_per_frame` (vs the reference's 41.54 ms):
  the state must stay OK to the end with no loss-recovery replay in the
  timed region (bench_mono.py:123-148).
- `tum_mono_points_only_ms_per_frame`: the `using_line=False` ablation
  with bench_mono.py:162-199's three outcomes (lost where point+line
  holds; surviving only through replays; or a clean cost delta). Lost
  frames and replays are its results, not failures.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from splslam_tpu_torch.bench.common import Bench, cuts, launch_check, summary, watched
from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence
from splslam_tpu_torch.ops import orb_kernel
from splslam_tpu_torch.slam.system import Sensor, Settings, System, TrackingState

SCENE_SEED = 4       # bench_mono.py:78
ATE_GATE = 0.15      # Sim3-aligned ATE-RMSE (tests/test_e2e_mono.py)
FPS = 30.0


@dataclass(frozen=True)
class Size:
    width: int = 640
    height: int = 480
    fx: float = 520.0
    n_frames: int = 120
    n_features: int = 1000
    n_levels: int = 8
    line_features: int = 128
    max_points: int = 16384
    max_keyframes: int = 128
    local_window: int = 2048
    batch: int = 8          # bench_mono.py:108
    warmup_frames: int = 24  # a throwaway pass before the repeats (0: none)


FULL = Size()
SMALL = Size(width=320, height=240, fx=260.0, n_frames=10, n_features=600, n_levels=4,
             line_features=64, max_points=8192, max_keyframes=64, local_window=1024,
             batch=4, warmup_frames=0)


def scene(size: Size, seed: int, n_frames: int):
    """(K, frames, gt) of the oscillating grid scene; a frame's pose does
    not depend on the sequence's length."""
    K, _, frames, gt = make_stereo_sequence(
        n_frames=n_frames, width=size.width, height=size.height, fx=size.fx,
        motion="oscillate", seed=SCENE_SEED + seed, osc_amp=0.5, texture="grid")
    return K, [l for l, _ in frames], gt


def settings(K, using_line: bool, size: Size = FULL) -> Settings:
    """bench_mono.py:85-92: mapping off, relocalization and loop
    detection at their defaults (on), each batch's stats read three
    batches late."""
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=0.0, width=size.width, height=size.height,
        n_features=size.n_features, n_levels=size.n_levels, fps=FPS,
        max_points=size.max_points, max_keyframes=size.max_keyframes,
        local_window=size.local_window, using_line=using_line,
        line_features=size.line_features, batch_defer_stats=True, batch_defer_depth=3,
        enable_local_mapping=False, min_kf_gap=20,
    )


def staged(images: list, dev: torch.device) -> torch.Tensor:
    """uint8 [B,H,W] on `dev`, copied from pinned memory on a GPU."""
    t = torch.from_numpy(np.ascontiguousarray(np.stack(images).astype(np.uint8)))
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def _ate(sysm: System, gt: np.ndarray) -> float:
    """Sim3-aligned ATE-RMSE of the frames tracked (their timestamps
    give their index)."""
    kept = [e for e in sysm.trajectory if not e.lost]
    if len(kept) < 3:
        return float("inf")
    est = np.stack([np.linalg.inv(e.Tcw) for e in kept])
    return ate_rmse(est, gt[[int(round(e.ts * FPS)) for e in kept]], align_scale=True)


def one_pass(b: Bench, st: Settings, images: list, gt: np.ndarray, B: int) -> dict:
    """A fresh System over `images`: frame by frame until the two-view
    init, then the rest in staged batches of B, each timed. A batch that
    leaves the state other than OK ends the pass there (bench_mono.py:
    130-137). Returns the System and what the pass measured."""
    n = len(images)
    sysm = watched(b.setup("systems", System, st, Sensor.MONOCULAR, b.device))
    i = 0
    while sysm.get_tracking_state() != TrackingState.OK and i < n:
        sysm.track_mono(images[i], i / FPS)
        i += 1
    init_end = i
    starts = list(range(init_end, n, B))
    batches = b.setup("staging", lambda: [staged(images[s:s + B], b.device) for s in starts])
    sysm.drain()
    b.settle()
    per_batch, lost_at, built = [], None, init_end
    t0 = time.perf_counter()
    for s, imgs in zip(starts, batches):
        _, ms = b.timed(sysm.track_mono_batch, imgs, [j / FPS for j in range(s, s + len(imgs))])
        per_batch.append(ms / len(imgs))
        built += len(imgs)
        if sysm.state != TrackingState.OK:
            lost_at = s
            break
    state = sysm.get_tracking_state()
    b.sync()
    region = (time.perf_counter() - t0) * 1e3 / max(built - init_end, 1)
    orb = launch_check(b, sysm, built)
    return {"system": sysm, "per_batch": per_batch, "region_ms": region,
            "init_frame": init_end - 1, "lost_at": lost_at, "state": state.name,
            "replays": sysm.replays, "ate": _ate(sysm, gt), "keyframes": sysm.n_kfs,
            "map_lines": int(sysm.map.lns.valid.sum()), "orb": orb}


def _trace_next_batch(b: Bench, sysm: System, images: list, lo: int, B: int, untraced):
    """One more batch (frames lo..lo+B-1) on the last pass's System,
    traced."""
    imgs = staged(images[lo:lo + B], b.device)
    return b.trace(f"one batch of {B} frames ({lo}-{lo + B - 1}) after the last repeat",
                   lambda: sysm.track_mono_batch(imgs, [j / FPS for j in range(lo, lo + B)]),
                   untraced, per=B)


def _public(p: dict) -> dict:
    return {k: v for k, v in p.items() if k not in ("system", "per_batch", "orb")}


def _repeats(b: Bench, size: Size, K, images, gt, using_line: bool) -> list[dict]:
    """R passes on fresh Systems; the last keeps its System."""
    passes = []
    for _ in range(b.repeats):
        if passes:
            passes[-1].pop("system")          # free the last repeat's System first
        passes.append(one_pass(b, settings(K, using_line, size), images[:size.n_frames],
                               gt, size.batch))
    return passes


def lines_row(b: Bench, size: Size, K, images, gt) -> dict:
    n = size.n_frames
    passes = _repeats(b, size, K, images, gt, True)
    stats = summary([p["per_batch"] for p in passes])
    trace = _trace_next_batch(b, passes[-1].pop("system"), images, n, size.batch,
                              stats["median_ms"])
    checks = {
        "state OK after every batch and at the end":
            all(p["lost_at"] is None and p["state"] == "OK" for p in passes),
        "0 loss-recovery replays": all(p["replays"] == 0 for p in passes),
        f"Sim3-aligned ATE < {ATE_GATE}": all(p["ate"] < ATE_GATE for p in passes),
        "one ORB launch a frame built": all(p["orb"][0] == p["orb"][1] for p in passes),
    }
    return b.row(
        "tum_mono_line_tracking_ms_per_frame", stats["median_ms"], "ms", checks,
        baseline="tum_mono_line_tracking_total", ms=stats["median_ms"], **stats,
        whole_region_ms_per_frame=[p["region_ms"] for p in passes], frames=n,
        batch=size.batch, sample="the synced wall of one timed batch over its frames",
        passes=[_public(p) for p in passes], orb_launches=[p["orb"][0] for p in passes],
        trace=trace)


def points_only_row(b: Bench, size: Size, K, images, gt, lines_ms: float | None) -> dict:
    n = size.n_frames
    passes = _repeats(b, size, K, images, gt, False)
    lost = [p["lost_at"] for p in passes if p["lost_at"] is not None]
    stats = summary([p["per_batch"] for p in passes])
    fields = {}
    if lost:
        value = None
        fields["points_only_lost_at_frame"] = lost
        fields["note"] = "points-only tracking is LOST where point+line holds the sequence"
        trace = None
    else:
        value = stats["median_ms"]
        replays = [p["replays"] for p in passes]
        if any(replays):
            fields["loss_recovery_replays"] = replays
            fields["note"] = ("points-only survives only via relocalization replays "
                              "(its wall is replay-dominated, not a tracking cost)")
        elif lines_ms is not None:
            fields["line_pipeline_cost_ms"] = lines_ms - value
        trace = _trace_next_batch(b, passes[-1]["system"], images, n, size.batch, value)
    passes[-1].pop("system")
    checks = {
        "poses finite where tracked to the end":
            all(np.isfinite(p["ate"]) for p in passes if p["lost_at"] is None),
        "one ORB launch a frame built": all(p["orb"][0] == p["orb"][1] for p in passes),
    }
    return b.row(
        "tum_mono_points_only_ms_per_frame", value, "ms", checks, **stats, **fields,
        whole_region_ms_per_frame=[p["region_ms"] for p in passes], frames=n,
        batch=size.batch, outcome_rule="lost frames and replays are results here",
        passes=[_public(p) for p in passes], orb_launches=[p["orb"][0] for p in passes],
        trace=trace)


def run(b: Bench, size: Size = FULL) -> list[dict]:
    b.reduced = cuts(size, FULL)
    # B frames past the sequence for the traced windows
    K, images, gt = b.setup("scene", scene, size, b.seed, size.n_frames + size.batch)
    if b.cuda:
        b.setup("kernel build", orb_kernel.build)
    if size.warmup_frames:    # the line detector's and the two-view init's first calls
        b.setup("warm-up", lambda: one_pass(b, settings(K, True, size),
                                            images[:size.warmup_frames], gt, size.batch))
    lines = lines_row(b, size, K, images, gt)
    return [lines, points_only_row(b, size, K, images, gt, lines["value"])]
