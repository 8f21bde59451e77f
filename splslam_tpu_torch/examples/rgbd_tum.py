"""TUM RGB-D driver (reference Examples/RGB-D/rgbd_tum.cc)."""

from splslam_tpu_torch.examples._common import driver_args, run_sequence
from splslam_tpu_torch.io.config import load_settings
from splslam_tpu_torch.io.datasets import imread_depth, imread_gray, load_tum_rgbd
from splslam_tpu_torch.slam.system import Sensor, System


def main(argv=None, device: str | None = None) -> int:
    a = driver_args("rgbd_tum", "CameraTrajectory.txt", argv)
    st, _ = load_settings(a.settings)
    rgb, depth, ts = load_tum_rgbd(a.sequence)
    sysm = System(st, Sensor.RGBD, device or a.device)
    # TUM depth PNGs are uint16 in units of 1/DepthMapFactor m; the System
    # applies settings.depth_map_factor
    feed = ((lambda p=p, d=d, t=t: sysm.track_rgbd(imread_gray(p), imread_depth(d), t))
            for p, d, t in zip(rgb, depth, ts))
    run_sequence(sysm, feed, len(ts))
    sysm.save_trajectory_tum(a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
