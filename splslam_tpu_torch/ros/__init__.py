"""ROS node adapters (port of splslam_tpu/ros; reference
Examples/ROS/PL-SLAM/src/ros_*.cc).

- `nodes.MonoGrabber` / `StereoGrabber` / `RGBDGrabber`: the message ->
  System glue (timestamp extraction, grayscale conversion, approximate
  L/R pairing), testable without a ROS installation.
- `nodes.run_*_node`: thin rospy wiring (subscribers, spin) used when
  `rospy` + `cv_bridge` are importable; without them the wiring raises a
  clear error instead of silently degrading.
"""

from splslam_tpu_torch.ros.nodes import (  # noqa: F401
    MonoGrabber,
    RGBDGrabber,
    StereoGrabber,
    run_mono_node,
    run_rgbd_node,
    run_stereo_node,
)
