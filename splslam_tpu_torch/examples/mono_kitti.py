"""KITTI monocular driver (reference Examples/Monocular/mono_kitti.cc)."""

from splslam_tpu_torch.examples._common import driver_args, run_sequence
from splslam_tpu_torch.io.config import load_settings
from splslam_tpu_torch.io.datasets import load_kitti_mono
from splslam_tpu_torch.io.native import PrefetchLoader
from splslam_tpu_torch.slam.system import Sensor, System


def main(argv=None, device: str | None = None) -> int:
    a = driver_args("mono_kitti", "CameraTrajectory.txt", argv)
    st, _ = load_settings(a.settings)
    imgs, ts = load_kitti_mono(a.sequence)
    sysm = System(st, Sensor.MONOCULAR, device or a.device)
    with PrefetchLoader(imgs, st.width, st.height) as dl:
        feed = ((lambda i=i, t=t: sysm.track_mono(dl[i], t))
                for i, t in enumerate(ts))
        run_sequence(sysm, feed, len(ts))
    # KITTI-mono export (reference SaveTrajectoryKITTIMono, src/System.cc:492)
    sysm.save_trajectory_kitti_mono(a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
