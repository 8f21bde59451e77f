"""The port's ROS grabbers (`splslam_tpu_torch/ros`) on
tests/test_ros_shim.py's cases (pairing, drop and conversion rules with
plain numpy "messages" and a recording stub system), and the port's CPU
`System` fed through `StereoGrabber` in shuffled arrival order with a
stamp skew and a stale unpaired left: the same poses as direct
`track_stereo` calls, exactly."""

import numpy as np
import pytest
import torch

from splslam_tpu_torch.io.synthetic import make_stereo_sequence
from splslam_tpu_torch.ros import MonoGrabber, RGBDGrabber, StereoGrabber
from splslam_tpu_torch.ros.nodes import _to_gray
from splslam_tpu_torch.slam.system import Sensor, Settings, System


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StubSystem:
    def __init__(self):
        self.calls = []

    def track_mono(self, img, ts):
        self.calls.append(("mono", img.shape, ts))
        return np.eye(4)

    def track_stereo(self, l, r, ts):
        self.calls.append(("stereo", l.shape, r.shape, ts))
        return np.eye(4)

    def track_rgbd(self, img, depth, ts):
        self.calls.append(("rgbd", img.shape, depth.shape, ts))
        return np.eye(4)


class _Stamp:
    """rospy.Time-like."""

    def __init__(self, t):
        self._t = t

    def to_sec(self):
        return self._t


def test_mono_grabber_converts_color_and_stamp():
    sysm = _StubSystem()
    g = MonoGrabber(sysm)
    rgb = np.zeros((8, 10, 3), np.uint8)
    g.grab(rgb, _Stamp(1.5))
    assert sysm.calls == [("mono", (8, 10), 1.5)]


def test_to_gray_weights_match_the_reference():
    from splslam_tpu.ros.nodes import _to_gray as j_to_gray

    rgb = np.random.default_rng(0).integers(0, 256, (6, 7, 3), dtype=np.uint8)
    for a in (rgb, rgb[:, :, :1], rgb[:, :, 0]):
        out = _to_gray(a)
        assert out.dtype == np.float32 and out.shape == (6, 7)
        np.testing.assert_array_equal(out, j_to_gray(a))


def test_stereo_grabber_pairs_within_skew():
    sysm = _StubSystem()
    g = StereoGrabber(sysm, max_skew_s=0.02)
    img = np.zeros((6, 6), np.float32)
    g.push_left(img, 0.000)
    assert sysm.calls == []            # right not yet arrived
    g.push_right(img, 0.010)           # within skew -> fires
    assert len(sysm.calls) == 1 and g.n_tracked == 1
    assert sysm.calls[0][3] == 0.0     # min of the pair


def test_stereo_grabber_drops_stale_unmatched():
    sysm = _StubSystem()
    g = StereoGrabber(sysm, max_skew_s=0.02)
    img = np.zeros((6, 6), np.float32)
    g.push_left(img, 0.0)              # will become stale
    g.push_left(img, 0.50)
    g.push_right(img, 0.505)           # pairs with the SECOND left
    assert g.n_tracked == 1
    assert sysm.calls[0][3] == 0.50


def test_rgbd_grabber_pairs_image_and_depth():
    sysm = _StubSystem()
    g = RGBDGrabber(sysm)
    g.push_image(np.zeros((5, 7, 3), np.uint8), 2.0)
    g.push_depth(np.ones((5, 7), np.float32), 2.001)
    assert sysm.calls == [("rgbd", (5, 7), (5, 7), 2.0)]


def test_run_node_without_ros_raises():
    from splslam_tpu_torch.ros import run_mono_node, run_rgbd_node, run_stereo_node

    for run in (run_mono_node, run_stereo_node, run_rgbd_node):
        with pytest.raises(RuntimeError, match="ROS installation"):
            run(_StubSystem())


def test_stereo_grabber_rectifies_before_tracking():
    """do_rectify parity (ros_stereo.cc:75-110 / ros_mynteye_stereo.cc):
    with rectify maps installed, frames reach TrackStereo remapped."""

    class _Capture(_StubSystem):
        def track_stereo(self, l, r, ts):
            self.left = l
            return super().track_stereo(l, r, ts)

    h, w = 8, 10
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    ident = (gx, gy)
    shift = (gx + 2.0, gy)             # sample 2 px to the right
    img = np.tile(np.arange(w, dtype=np.float32), (h, 1))

    sysm = _Capture()
    g = StereoGrabber(sysm, rectify_maps=(shift, ident))
    g.push_left(img, 0.0)
    g.push_right(img, 0.0)
    assert g.n_tracked == 1
    # interior columns shifted by 2 (border clamped by cv2.remap)
    assert np.allclose(sysm.left[:, :w - 2], img[:, 2:])


def _settings(K, bf):
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=400, n_levels=3, th_depth=40.0, fps=10,
        max_points=4096, max_keyframes=16, local_window=512,
        enable_local_mapping=False, enable_relocalization=False,
        enable_loop_closing=False)


def test_system_through_stereo_grabber_matches_direct_calls():
    """Arrival order shuffled (the right image first on a random half of
    the frames), right stamps 5 ms late, and a stale left with no partner
    before frame 4: every pair is tracked once, the stale left dropped,
    and the poses are the direct calls' exactly."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=8, motion="forward",
                                            width=320, height=240)
    direct = System(_settings(K, bf), Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        direct.track_stereo(l, r, i * 0.1)

    fed = System(_settings(K, bf), Sensor.STEREO, "cpu")
    g = StereoGrabber(fed)
    right_first = np.random.default_rng(7).random(len(frames)) < 0.5
    for i, (l, r) in enumerate(frames):
        t = i * 0.1
        if i == 4:
            g.push_left(frames[3][0], _Stamp(t - 0.05))   # stale, never paired
        if right_first[i]:
            g.push_right(r, t + 0.005)
            g.push_left(l, _Stamp(t))
        else:
            g.push_left(l, t)
            g.push_right(r, _Stamp(t + 0.005))
    assert right_first.any() and not right_first.all()
    assert g.n_tracked == len(frames)
    assert [e.ts for e in fed.trajectory] == [e.ts for e in direct.trajectory]
    np.testing.assert_array_equal(fed.poses(), direct.poses())
    assert fed.get_tracking_state() == direct.get_tracking_state()
