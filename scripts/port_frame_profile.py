"""Device kernels and time per stereo frame of a checkout of the PyTorch
port (`splslam_tpu_torch`), on one GPU.

    python3 scripts/port_frame_profile.py [--root DIR] [--frames 30]

Imports `splslam_tpu_torch` from DIR (default: the checkout that holds
this script), so that two trees can be compared in turns on one card.
The sequence comes from this checkout's `splslam_tpu_torch/io/synthetic.py`
and the configuration and timing helpers from its `chip_smoke.py`, both
loaded by path. Tracks KITTI-size frames at chip_smoke's phase-4
configuration (2000 features, 8 levels, mapping off) and prints one JSON
line: the card, `track_stereo` ms per frame (median over frames 10 on),
`orb_describe` launches per frame, and, from torch.profiler with CUDA
activity over one `build_frame_stereo` call and over one tracked frame,
the count of device activities, their device ms, and the device ms of the
`orb_describe` kernel.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("port_frame_profile: no CUDA device")
    smoke = _load(HERE / "chip_smoke.py", "_chip_smoke")
    synth = _load(HERE / "splslam_tpu_torch" / "io" / "synthetic.py", "_synthetic")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from splslam_tpu_torch.ops import orb_kernel as OK
    from splslam_tpu_torch.slam.frame import build_frame_stereo
    from splslam_tpu_torch.slam.system import Sensor, Settings, System

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K, bf, frames, _ = synth.make_stereo_sequence(
        n_frames=args.frames, width=smoke.KITTI_W, height=smoke.KITTI_H,
        fx=718.0, baseline=0.54, motion="forward", seed=3)
    sysm = System(smoke.kitti_settings(Settings, K, bf), Sensor.STEREO, "cuda")
    OK.orb_describe.launches = 0
    times = []
    for i, (l, r) in enumerate(frames[:-1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sysm.track_stereo(l, r, i * 0.1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = OK.orb_describe.launches / len(times)
    imgs = torch.from_numpy(np.stack(frames[-1]).astype(np.uint8)).cuda()
    # trees before the scale table became an argument built it themselves
    with_scales = "scales" in inspect.signature(build_frame_stereo).parameters
    build = smoke.device_kernels(lambda: build_frame_stereo(
        imgs[0].float(), imgs[1].float(), sysm.cam, sysm.spec,
        *((sysm.scales,) if with_scales else ()), line_capacity=sysm.line_cap))
    track = smoke.device_kernels(
        lambda: sysm.track_stereo(*frames[-1], len(frames) * 0.1))
    print(json.dumps({
        "root": str(Path(args.root).resolve()),
        "card": smoke.card_line(),
        "track_ms_median": float(np.median(times[10:])),
        "track_ms_all": [round(t, 2) for t in times],
        "orb_launches_per_frame": launches,
        "build_frame": {"device_activities": build[0], "device_ms": build[1],
                        "orb_describe_ms": build[2]},
        "track_frame": {"device_activities": track[0], "device_ms": track[1],
                        "orb_describe_ms": track[2]},
    }))


if __name__ == "__main__":
    main()
