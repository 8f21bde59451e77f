"""ROS image-grabber adapters for the System facade (port of
splslam_tpu/ros/nodes.py; the port's `System` is fed host numpy images
and uploads them itself).

Behavior contracts from the reference nodes
(Examples/ROS/PL-SLAM/src/ros_mono.cc, ros_stereo.cc, ros_rgbd.cc):

- mono: one `sensor_msgs/Image` subscriber; every message becomes
  `TrackMonocular(gray, stamp)`.
- stereo: two subscribers joined by an ApproximateTime(queue=10)
  synchronizer; optional rectification from the LEFT.*/RIGHT.* YAML
  blocks before `TrackStereo` (ros_stereo.cc:75-110 — pass
  `rectify_maps`/`rectify_yaml`).
- rgbd: image + depth joined the same way -> `TrackRGBD`.
- the MYNT-EYE nodes (ros_mynteye_mono.cc, ros_mynteye_stereo.cc)
  differ from mono/stereo only in their CLI topic arguments and the
  `do_rectify` flag — covered by the `*_topic` / `rectify_yaml`
  parameters of `run_mono_node` / `run_stereo_node`.

The grabbers below are transport-free: they accept any object with
`.data` convertible to a numpy image and a `stamp` (float seconds or a
rospy.Time-like with `.to_sec()`), so the pairing / conversion logic is
unit-tested without a ROS installation. `run_*_node` adds the rospy
subscriptions when ROS is present.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np


def _to_sec(stamp: Any) -> float:
    if hasattr(stamp, "to_sec"):
        return float(stamp.to_sec())
    return float(stamp)


def _to_gray(img: Any) -> np.ndarray:
    """Accept HxW, HxWx1, HxWx3 (RGB/BGR) arrays -> HxW float32 gray.

    Mirrors the reference's cvtColor(mImGray, CV_RGB2GRAY) in the Track*
    entry points (src/Tracking.cc:244-258) so the nodes can feed color
    topics directly."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    elif a.ndim == 3 and a.shape[2] >= 3:
        # reference uses RGB weights via cvtColor; BGR topics differ only
        # in the .114/.299 swap, below the feature detector's threshold
        a = (0.299 * a[:, :, 0] + 0.587 * a[:, :, 1]
             + 0.114 * a[:, :, 2])
    return a.astype(np.float32)


class MonoGrabber:
    """ros_mono.cc ImageGrabber::GrabImage."""

    def __init__(self, system):
        self.system = system

    def grab(self, msg_img, stamp) -> np.ndarray:
        return self.system.track_mono(_to_gray(msg_img), _to_sec(stamp))


class StereoGrabber:
    """ros_stereo.cc ImageGrabber::GrabStereo with the ApproximateTime
    pairing made explicit: push left/right messages in any order; a
    track fires whenever the heads of both queues are within
    `max_skew_s` (the synchronizer's role), and stale unmatched heads
    are dropped."""

    def __init__(self, system, max_skew_s: float = 0.02, queue: int = 10,
                 rectify_maps=None):
        """`rectify_maps`: optional (map_left, map_right) from
        io.datasets.euroc_rectify_maps — the reference's `do_rectify`
        path (ros_stereo.cc / ros_mynteye_stereo.cc: initUndistortRectifyMap
        from the LEFT.*/RIGHT.* YAML blocks, then cv::remap per frame)."""
        self.system = system
        self.max_skew = max_skew_s
        self.rectify_maps = rectify_maps
        self._left: deque = deque(maxlen=queue)
        self._right: deque = deque(maxlen=queue)
        self.n_tracked = 0

    def push_left(self, msg_img, stamp):
        img = _to_gray(msg_img)
        if self.rectify_maps is not None:
            from splslam_tpu_torch.io.datasets import rectify

            img = rectify(img, self.rectify_maps[0])
        self._left.append((_to_sec(stamp), img))
        return self._try_pair()

    def push_right(self, msg_img, stamp):
        img = _to_gray(msg_img)
        if self.rectify_maps is not None:
            from splslam_tpu_torch.io.datasets import rectify

            img = rectify(img, self.rectify_maps[1])
        self._right.append((_to_sec(stamp), img))
        return self._try_pair()

    def _try_pair(self):
        out = None
        while self._left and self._right:
            tl, il = self._left[0]
            tr, ir = self._right[0]
            if abs(tl - tr) <= self.max_skew:
                self._left.popleft()
                self._right.popleft()
                out = self.system.track_stereo(il, ir, min(tl, tr))
                self.n_tracked += 1
            elif tl < tr:
                self._left.popleft()   # stale left, no partner
            else:
                self._right.popleft()
        return out


class RGBDGrabber:
    """ros_rgbd.cc ImageGrabber::GrabRGBD (image + registered depth)."""

    def __init__(self, system, max_skew_s: float = 0.02, queue: int = 10):
        self.system = system
        self.max_skew = max_skew_s
        self._img: deque = deque(maxlen=queue)
        self._depth: deque = deque(maxlen=queue)
        self.n_tracked = 0

    def push_image(self, msg_img, stamp):
        self._img.append((_to_sec(stamp), _to_gray(msg_img)))
        return self._try_pair()

    def push_depth(self, depth, stamp):
        self._depth.append(
            (_to_sec(stamp), np.asarray(depth, np.float32))
        )
        return self._try_pair()

    def _try_pair(self):
        out = None
        while self._img and self._depth:
            ti, im = self._img[0]
            td, dp = self._depth[0]
            if abs(ti - td) <= self.max_skew:
                self._img.popleft()
                self._depth.popleft()
                out = self.system.track_rgbd(im, dp, min(ti, td))
                self.n_tracked += 1
            elif ti < td:
                self._img.popleft()
            else:
                self._depth.popleft()
        return out


def _require_ros():
    try:
        import rospy  # noqa: F401
        from cv_bridge import CvBridge  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "run_*_node needs a ROS installation (rospy + cv_bridge); "
            "this environment has none. Use the Grabber classes with "
            "your own transport, or the dataset drivers in "
            "splslam_tpu_torch.examples for offline sequences."
        ) from e


def run_mono_node(system, topic: str = "/camera/image_raw"):
    """rosrun entry point parity for ros_mono.cc."""
    _require_ros()
    import rospy
    from cv_bridge import CvBridge
    from sensor_msgs.msg import Image

    bridge = CvBridge()
    grab = MonoGrabber(system)
    rospy.Subscriber(
        topic, Image,
        lambda m: grab.grab(bridge.imgmsg_to_cv2(m), m.header.stamp),
        queue_size=1,
    )
    rospy.spin()


def run_stereo_node(system, left_topic: str = "/camera/left/image_raw",
                    right_topic: str = "/camera/right/image_raw",
                    rectify_yaml: str | None = None):
    """rosrun entry point parity for ros_stereo.cc (and, with explicit
    camera topics + `rectify_yaml`, for ros_mynteye_stereo.cc — the
    reference's MYNT-EYE node differs only in its CLI topic arguments
    and `do_rectify` handling)."""
    _require_ros()
    import rospy
    from cv_bridge import CvBridge
    from sensor_msgs.msg import Image

    maps = None
    if rectify_yaml is not None:
        from splslam_tpu_torch.io.config import _load_cv_yaml
        from splslam_tpu_torch.io.datasets import euroc_rectify_maps

        maps = euroc_rectify_maps(_load_cv_yaml(rectify_yaml))
    bridge = CvBridge()
    grab = StereoGrabber(system, rectify_maps=maps)
    rospy.Subscriber(
        left_topic, Image,
        lambda m: grab.push_left(bridge.imgmsg_to_cv2(m), m.header.stamp),
        queue_size=10,
    )
    rospy.Subscriber(
        right_topic, Image,
        lambda m: grab.push_right(bridge.imgmsg_to_cv2(m), m.header.stamp),
        queue_size=10,
    )
    rospy.spin()


def run_rgbd_node(system, image_topic: str = "/camera/rgb/image_raw",
                  depth_topic: str = "/camera/depth_registered/image_raw"):
    """rosrun entry point parity for ros_rgbd.cc."""
    _require_ros()
    import rospy
    from cv_bridge import CvBridge
    from sensor_msgs.msg import Image

    bridge = CvBridge()
    grab = RGBDGrabber(system)
    rospy.Subscriber(
        image_topic, Image,
        lambda m: grab.push_image(bridge.imgmsg_to_cv2(m), m.header.stamp),
        queue_size=10,
    )
    rospy.Subscriber(
        depth_topic, Image,
        lambda m: grab.push_depth(bridge.imgmsg_to_cv2(m), m.header.stamp),
        queue_size=10,
    )
    rospy.spin()
