"""Where a monocular point+line frame of the PyTorch port
(`splslam_tpu_torch`) spends its time, on one GPU.

    python3 scripts/port_mono_profile.py [--frames 40] [--no-lines]

Tracks chip_smoke.py's phase-9 sequence and configuration (bench_mono.py's:
640x480, fx 520, the grid texture, oscillating motion, seed 4; 1000
features, 8 levels, 128 line slots; mapping, relocalization and loop
closing off) with `System.track_mono`, one frame at a time, and prints
one JSON line: the card, ms per frame (median over frames from init + 10
on), and for the same frames the synced ms of each stage a frame runs
(`build_frame_mono`, `extract_orb`, `extract_lines`, the point and line
windows, the matchers, each `pose_optimize` solve), with the calls a
frame. A stage's time includes the host work of launching it and one
synchronize on each side, so the stages do not add up to the frame.
Then, over one more tracked frame, the device activities and their
device ms (torch.profiler, CUDA activity), and the host syncs that frame
makes (`torch.cuda.set_sync_debug_mode("warn")`, counted by
scripts/port_sync_probe.py's `sync_sites`: the port's source lines on the
stack of each).
Configuration and timing helpers come from `chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from port_sync_probe import sync_sites  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--no-lines", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_mono_profile: no CUDA device")
    import chip_smoke as smoke
    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.slam import frame as FR
    from splslam_tpu_torch.slam import pipeline as PL
    from splslam_tpu_torch.slam import tracking as TR
    from splslam_tpu_torch.slam.system import Sensor, Settings, System

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K, _, frames, _ = make_stereo_sequence(
        n_frames=args.frames + 1, width=smoke.MONO_W, height=smoke.MONO_H,
        fx=520.0, motion="oscillate", seed=4, osc_amp=0.5, texture="grid")
    sysm = System(smoke.mono_settings(Settings, K, not args.no_lines),
                  Sensor.MONOCULAR, "cuda")

    stages = {name: [] for name in (
        "build_frame_mono", "extract_orb", "extract_lines",
        "assemble_local_window", "assemble_line_window", "motion_model_match",
        "local_map_match", "line_projection_match", "pose_optimize")}
    owners = {"build_frame_mono": PL, "extract_orb": FR, "extract_lines": FR,
              "assemble_local_window": PL, "assemble_line_window": PL,
              "motion_model_match": TR, "local_map_match": TR,
              "line_projection_match": TR, "pose_optimize": TR}
    saved = {name: getattr(mod, name) for name, mod in owners.items()}
    for name, mod in owners.items():
        setattr(mod, name, smoke._timed(saved[name], stages[name], "cuda"))
    times, marks = [], []
    try:
        for i, (img, _) in enumerate(frames[:-1]):
            marks.append({k: len(v) for k, v in stages.items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sysm.track_mono(img, i / 30.0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        for name, mod in owners.items():
            setattr(mod, name, saved[name])
    sysm.drain()
    i_init = int(round(sysm.trajectory[1].ts * 30.0))
    first = i_init + 10
    per_stage = {}
    n_frames = len(times) - first
    for name, xs in stages.items():
        xs = xs[marks[first][name]:] if first < len(marks) else []
        per_stage[name] = {
            "calls_per_frame": len(xs) / max(n_frames, 1),
            "ms_median_per_call": float(np.median(xs)) if xs else None,
            "ms_per_frame": float(np.sum(xs)) / max(n_frames, 1),
        }

    img = frames[-1][0]
    ts = (len(frames) - 1) / 30.0
    n_dev, dev_ms, orb_ms = smoke.device_kernels(lambda: sysm.track_mono(img, ts))
    syncs = sync_sites(lambda: sysm.track_mono(img, ts + 1 / 30.0))
    print(json.dumps({
        "card": smoke.card_line(),
        "lines": not args.no_lines,
        "init_frame": i_init,
        "frames_timed": n_frames,
        "track_mono_ms_median": float(np.median(times[first:])),
        "track_mono_ms_p90": float(np.percentile(times[first:], 90)),
        "stages": per_stage,
        "tracked_frame": {"device_activities": n_dev, "device_ms": dev_ms,
                          "orb_describe_ms": orb_ms,
                          "host_syncs": sum(syncs.values()), "sync_sites": syncs},
    }))


if __name__ == "__main__":
    main()
