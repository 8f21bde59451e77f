"""KITTI stereo driver (reference Examples/Stereo/stereo_kitti.cc)."""

from splslam_tpu_torch.examples._common import driver_args, run_sequence
from splslam_tpu_torch.io.config import load_settings
from splslam_tpu_torch.io.datasets import load_kitti_stereo
from splslam_tpu_torch.io.native import PrefetchLoader
from splslam_tpu_torch.slam.system import Sensor, System


def main(argv=None, device: str | None = None) -> int:
    a = driver_args("stereo_kitti", "CameraTrajectory.txt", argv)
    st, _ = load_settings(a.settings)
    left, right, ts = load_kitti_stereo(a.sequence)
    sysm = System(st, Sensor.STEREO, device or a.device)
    # Native prefetcher: the C++ pool decodes frames i+1.. while the card
    # tracks frame i (native/dataloader.cpp).
    with PrefetchLoader(left, st.width, st.height) as dl_l, \
            PrefetchLoader(right, st.width, st.height) as dl_r:
        feed = ((lambda i=i, t=t: sysm.track_stereo(dl_l[i], dl_r[i], t))
                for i, t in enumerate(ts))
        run_sequence(sysm, feed, len(ts))
    sysm.save_trajectory_kitti(a.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
