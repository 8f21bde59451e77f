"""EuRoC stereo driver with rectification (reference
Examples/Stereo/stereo_euroc.cc: cv::initUndistortRectifyMap + remap)."""

from splslam_tpu_torch.examples._common import driver_args, run_sequence
from splslam_tpu_torch.io.config import load_settings
from splslam_tpu_torch.io.datasets import (euroc_rectify_maps, imread_gray,
                                           load_euroc, rectify)
from splslam_tpu_torch.slam.system import Sensor, System


def main(argv=None, device: str | None = None) -> int:
    a = driver_args("stereo_euroc", "CameraTrajectory.txt", argv)
    st, raw = load_settings(a.settings)
    left, right, ts = load_euroc(a.sequence)
    map_l, map_r = euroc_rectify_maps(raw)
    sysm = System(st, Sensor.STEREO, device or a.device)
    feed = ((lambda l=l, r=r, t=t: sysm.track_stereo(
                rectify(imread_gray(l), map_l), rectify(imread_gray(r), map_r), t))
            for l, r, t in zip(left, right, ts))
    run_sequence(sysm, feed, len(ts))
    sysm.save_trajectory_tum(a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
