"""Live stereo-camera driver (reference Examples/Stereo/stereo_mynt.cc).

The reference pulls live frames from a MYNT EYE stereo camera through its
SDK in a signal-interruptible loop (stereo_mynt.cc:169-185), optionally
rectifying with the LEFT.*/RIGHT.* calibration of the settings YAML
(stereo_mynt.cc:94-131), and saves the KITTI-format trajectory on exit
(stereo_mynt.cc:188).

Frame sources:
- `MyntSource`: the MYNT EYE Python SDK, when importable;
- `CvSource`: any UVC stereo pair through cv2.VideoCapture, two device ids
  or one side-by-side device split down the middle;
- any iterable yielding `(left_gray, right_gray, timestamp)`.
"""

from __future__ import annotations

import argparse
import signal

import numpy as np

from splslam_tpu_torch.io.config import load_settings
from splslam_tpu_torch.io.datasets import euroc_rectify_maps, rectify
from splslam_tpu_torch.slam.system import Sensor, System


class MyntSource:
    """MYNT EYE SDK stream (reference stereo_mynt.cc:134-185); raises
    ImportError where the vendor SDK is not installed."""

    def __init__(self):
        import mynteye

        self._dev = mynteye.Device.select()
        self._dev.start()

    def __iter__(self):
        while True:
            left, right, ts = self._dev.get_latest_stereo()
            yield left, right, ts * 1e-5  # SDK timestamp unit, .cc:182


class CvSource:
    """Generic UVC stereo via OpenCV: `ids=(0, 1)` for two devices, or
    `ids=(0,)` for a single side-by-side stream split in half."""

    def __init__(self, ids=(0,)):
        import cv2

        self._cv2 = cv2
        self._caps = [cv2.VideoCapture(i) for i in ids]
        self._split = len(ids) == 1
        self._t = 0.0

    def __iter__(self):
        cv2 = self._cv2
        while True:
            imgs = []
            for cap in self._caps:
                ok, img = cap.read()
                if not ok:
                    return
                if img.ndim == 3:
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                imgs.append(img)
            if self._split:
                w = imgs[0].shape[1] // 2
                imgs = [imgs[0][:, :w], imgs[0][:, w:]]
            self._t += 1.0 / 25.0  # SDK FRAME_RATE default, .cc:152
            yield imgs[0], imgs[1], self._t


def run_live(settings_path: str, source, do_rectify: bool = True,
             out_path: str = "CameraTrajectory.txt",
             max_frames: int | None = None, device: str = "cuda",
             **overrides) -> System:
    """The reference main loop: track frames from `source` until SIGINT
    (or `max_frames`), then save the KITTI trajectory. `overrides` are
    Settings fields applied over the YAML."""
    st, raw = load_settings(settings_path, **overrides)
    maps = None
    if do_rectify:
        need = [f"{s}.{k}" for s in ("LEFT", "RIGHT") for k in ("K", "D", "R", "P")]
        missing = [k for k in need if k not in raw]
        if missing:  # the reference errors out, stereo_mynt.cc:121-126
            raise ValueError(
                f"calibration parameters to rectify stereo are missing: {missing}")
        maps = euroc_rectify_maps(raw)
    sysm = System(st, Sensor.STEREO, device)

    stop = {"flag": False}

    def _sigint(sig, frm):  # reference exit_while, stereo_mynt.cc:36-39
        stop["flag"] = True

    prev = None
    try:
        prev = signal.signal(signal.SIGINT, _sigint)
    except ValueError:
        pass  # not on the main thread
    n = 0
    try:
        for left, right, ts in source:
            if stop["flag"]:
                break
            if maps is not None:
                left = rectify(np.asarray(left), maps[0])
                right = rectify(np.asarray(right), maps[1])
            sysm.track_stereo(left, right, float(ts))
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    finally:
        if prev is not None:
            signal.signal(signal.SIGINT, prev)
    sysm.drain()
    sysm.save_trajectory_kitti(out_path)
    return sysm


def main(argv=None, device: str | None = None) -> int:
    p = argparse.ArgumentParser(prog="stereo_mynt")
    p.add_argument("settings", help="reference settings YAML")
    p.add_argument("do_rectify", help="true or false")
    p.add_argument("out", nargs="?", default="CameraTrajectory.txt")
    p.add_argument("source", nargs="?", default=None, help="cv:<id>[,<id>]")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    a = p.parse_args(argv)
    if a.source and a.source.startswith("cv:"):
        source = CvSource(tuple(int(i) for i in a.source[3:].split(",")))
    else:
        try:
            source = MyntSource()
        except ImportError:
            print("MYNT EYE SDK not installed; falling back to cv:0")
            source = CvSource((0,))
    run_live(a.settings, source, a.do_rectify.lower() == "true", a.out, device=device or a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
