"""Where a full-width global BA of the PyTorch port spends its host time.

    python3 scripts/port_gba_host_profile.py [--root DIR] [--reps 8]

Imports `splslam_tpu_torch` from DIR (default: the checkout that holds
this script), so that two trees can be run in turns on one card. Builds
chip_smoke.py phase 5's map (40 KITTI-size frames with mapping, a
keyframe every 4 frames) and runs `run_global_ba(rounds=1)` `--reps`
times from identical copies, printing for each the ms until the call
returns to the host and the ms until the card is done (a host-bound
solve returns only just before the card finishes), and the caching
allocator's new device segments over the repeats. Then one more solve
under torch.profiler with CPU activity: the ops by their own host time,
with their call counts (`cudaLaunchKernel` counts the launches).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("port_gba_host_profile: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = CS
    spec.loader.exec_module(CS)
    from splslam_tpu_torch.io.synthetic import make_stereo_sequence
    from splslam_tpu_torch.slam import system as TS

    card = CS.card_line()
    K, bf, leg, _ = make_stereo_sequence(
        n_frames=CS.BATCH_FRAMES, width=CS.KITTI_W, height=CS.KITTI_H, fx=718.0,
        baseline=0.54, motion="forward", seed=3)
    st = dataclasses.replace(CS.kitti_settings(TS.Settings, K, bf),
                             enable_local_mapping=True, force_kf_every=4)
    sysm = TS.System(st, TS.Sensor.STEREO, "cuda")
    for i, (l, r) in enumerate(leg[:CS.N_FRAMES]):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.get_tracking_state()
    snap = CS._snapshot(sysm)
    lc = sysm.loop_closer
    returned, done = [], []
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    for _ in range(args.reps):
        CS._restore(sysm, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lc.run_global_ba(rounds=1)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        returned.append((t1 - t0) * 1e3)
        done.append((time.perf_counter() - t0) * 1e3)
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments
    print(f"{args.root} run_global_ba at full width: ms to return "
          f"{[round(x, 1) for x in returned]}, ms to done {[round(x, 1) for x in done]}, "
          f"new device segments over the repeats {segments}, on {card}", flush=True)
    CS._restore(sysm, snap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lc.run_global_ba(rounds=1)
        torch.cuda.synchronize()
    print(f"{args.root} one more under torch.profiler (CPU activity):")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=18))


if __name__ == "__main__":
    main()
