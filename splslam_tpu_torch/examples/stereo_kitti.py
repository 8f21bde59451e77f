"""KITTI stereo driver (reference Examples/Stereo/stereo_kitti.cc)."""

from splslam_tpu_torch.examples._common import driver_args, run_sequence
from splslam_tpu_torch.io.config import load_settings
from splslam_tpu_torch.io.datasets import imread_gray, load_kitti_stereo
from splslam_tpu_torch.slam.system import Sensor, System


def main(argv=None, device: str | None = None) -> int:
    a = driver_args("stereo_kitti", "CameraTrajectory.txt", argv)
    st, _ = load_settings(a.settings)
    left, right, ts = load_kitti_stereo(a.sequence)
    sysm = System(st, Sensor.STEREO, device or a.device)
    feed = ((lambda l=l, r=r, t=t: sysm.track_stereo(imread_gray(l), imread_gray(r), t))
            for l, r, t in zip(left, right, ts))
    run_sequence(sysm, feed, len(ts))
    sysm.save_trajectory_kitti(a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
