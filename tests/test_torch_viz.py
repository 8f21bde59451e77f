"""The port's viewer and AR overlay (`splslam_tpu_torch/viz`) against the
JAX package's (`splslam_tpu/viz`): `draw_frame` on the same tables and
`render_current_frame` of a 6-frame CPU `System` (320x240) against the
JAX `draw_frame` on that System's numpy tables, pixel for pixel; the map
figure; the live `Viewer` thread with the reference's stop / release /
finish handshake (tests/test_viz.py:40-78); and `detect_plane`,
`ARState.try_anchor` and `render_ar_frame` equal to splslam_tpu/viz/ar.py
on the same point sets (the plane and anchor to float64 round-off: the
code is the same, the inputs identical)."""

import glob
import os
import time

import numpy as np
import pytest
import torch

from splslam_tpu.viz import ar as JAR
from splslam_tpu.viz import draw as JD
from splslam_tpu_torch.io.synthetic import make_stereo_sequence
from splslam_tpu_torch.slam.system import Sensor, Settings, System
from splslam_tpu_torch.viz import Viewer, plot_map
from splslam_tpu_torch.viz import ar as TAR
from splslam_tpu_torch.viz import draw as TD


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tier-1 runs test files side by side: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(K, bf):
    return Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=400, n_levels=3, th_depth=40.0, fps=10,
        max_points=4096, max_keyframes=16, local_window=512,
        enable_local_mapping=False, enable_relocalization=False,
        enable_loop_closing=False)


@pytest.fixture(scope="module")
def six():
    """A CPU System after 6 forward frames, and its frames."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=6, motion="forward",
                                            width=320, height=240)
    sysm = System(_settings(K, bf), Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    return sysm, frames


def test_draw_frame_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    kp = rng.uniform(0, 128, (50, 2)).astype(np.float32)
    tracked = rng.random(50) < 0.6
    seg = rng.uniform(0, 96, (12, 4)).astype(np.float32)
    lt = rng.random(12) < 0.5
    out = TD.draw_frame(img, kp, tracked, seg, lt, "OK  KFs:1")
    np.testing.assert_array_equal(out, JD.draw_frame(img, kp, tracked, seg, lt,
                                                     "OK  KFs:1"))
    assert out.shape == (96, 128, 3) and out.dtype == np.uint8


def test_render_current_frame_matches_jax_draw_frame(six):
    sysm, frames = six
    img = frames[-1][0]
    st = sysm.step
    tracked = st.lm_gid.numpy() >= 0
    txt = (f"{sysm.state.name}  KFs:{sysm.n_kfs} "
           f"MPs:{int(sysm.map.pts.valid.sum())}  matches:{int(tracked.sum())}")
    ref = JD.draw_frame(img, st.frame.feat.xy.numpy(), tracked,
                        st.frame.lines.seg.numpy(), st.ll_gid.numpy() >= 0, txt)
    out = TD.render_current_frame(sysm, img)
    assert tracked.sum() > 100 and sysm.state.name == "OK"
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (240, 320, 3)


def test_last_image_is_the_callers_left_image(six):
    sysm, frames = six
    assert sysm.last_image is not None
    np.testing.assert_array_equal(sysm.last_image, frames[-1][0])


def test_plot_map_writes_a_figure(six, tmp_path):
    sysm, _ = six
    out = str(tmp_path / "map.png")
    plot_map(sysm, out)
    assert os.path.getsize(out) > 5000
    # the trajectory the figure draws is poses_reconstructed's, read
    # without draining the tracker
    np.testing.assert_allclose(
        TD._trajectory(sysm, sysm.map.kfs.Tcw.numpy()),
        sysm.poses_reconstructed(), atol=1e-6)


def test_plot_map_leaves_the_pending_stats_queued(tmp_path):
    """A direct `plot_map` call does not drain (by design, unlike the JAX
    package's, whose `poses_reconstructed` drains): the frame stats still
    in flight stay queued, with the trajectory and keyframes they would
    decide, until the tracker's own `drain` consumes them."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=3, motion="forward",
                                            width=320, height=240)
    sysm = System(_settings(K, bf), Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    n_pending, n_traj, n_kfs = len(sysm._pending), len(sysm.trajectory), sysm.n_kfs
    assert n_pending >= 1
    plot_map(sysm, str(tmp_path / "map.png"))
    assert os.path.getsize(tmp_path / "map.png") > 5000
    assert len(sysm._pending) == n_pending
    assert (len(sysm.trajectory), sysm.n_kfs) == (n_traj, n_kfs)
    sysm.drain()
    assert len(sysm._pending) == 0
    assert len(sysm.trajectory) == n_traj + n_pending == len(frames)


def test_live_viewer_loop(tmp_path):
    """The live Viewer thread (reference src/Viewer.cc Run loop +
    RequestStop/Release/RequestFinish handshake): renders overlay PNGs at
    cadence while tracking runs, honors stop/release, finishes clean."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=8, motion="forward",
                                            width=320, height=240)
    sysm = System(_settings(K, bf), Sensor.STEREO, "cpu")
    viewer = Viewer(sysm, fps=200.0, out_dir=str(tmp_path), show=False,
                    map_every=2).start()
    try:
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
            time.sleep(0.02)  # give the viewer thread a tick per frame
        sysm.drain()
        # stop handshake (the reference viewer parks while loop closing runs)
        viewer.request_stop()
        deadline = time.time() + 5.0
        while not viewer.is_stopped() and time.time() < deadline:
            time.sleep(0.01)
        assert viewer.is_stopped()
        viewer.release()
    finally:
        viewer.request_finish()
        viewer.join()
    assert viewer.is_finished()
    assert not viewer._warned                # no render tick failed
    pngs = glob.glob(str(tmp_path / "frame_*.png"))
    assert len(pngs) >= 3, pngs          # rendered while tracking
    assert viewer.n_rendered == len(pngs)
    assert (tmp_path / "map.png").exists()  # periodic map refresh


def _plane_points(n=200, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, size=(n, 2))
    return np.stack([xy[:, 0], xy[:, 1], 3.0 + 0.002 * rng.standard_normal(n)],
                    axis=-1)


class _Step:
    def __init__(self, xyz, gid):
        self.lm_xyz = xyz
        self.lm_gid = gid


class _Sys:
    def __init__(self, step):
        self.step = step


@pytest.mark.parametrize("case", ["plane", "outliers", "degenerate"])
def test_detect_plane_matches_jax(case):
    pts = _plane_points()
    if case == "outliers":
        out = np.array([[0.3, -0.2, 1.0], [-0.5, 0.1, 5.5], [0.9, 0.9, 7.0]])
        pts = np.concatenate([pts, np.tile(out, (8, 1))])
    elif case == "degenerate":
        pts = np.zeros((5, 3))
    got, ref = TAR.detect_plane(pts), JAR.detect_plane(pts)
    if ref is None:
        assert got is None
        return
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-12)
    assert abs(got[1] - ref[1]) < 1e-12


def test_try_anchor_and_cube_match_jax():
    xyz = _plane_points().astype(np.float32)
    gid = np.where(np.arange(len(xyz)) % 7 == 3, -1, np.arange(len(xyz)))
    ja, ta = JAR.ARState(cube_size=0.4), TAR.ARState(cube_size=0.4)
    assert ja.try_anchor(_Sys(_Step(xyz, gid)))
    # the port reads its tracker's tensors
    assert ta.try_anchor(_Sys(_Step(torch.from_numpy(xyz), torch.from_numpy(gid))))
    np.testing.assert_allclose(ta.anchor, ja.anchor, atol=1e-12)
    np.testing.assert_allclose(ta.basis, ja.basis, atol=1e-12)
    np.testing.assert_allclose(ta.cube_vertices(), ja.cube_vertices(), atol=1e-12)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    img = np.zeros((96, 128, 3), np.uint8)
    np.testing.assert_array_equal(
        TAR.draw_ar_cube(img.copy(), np.eye(4), K, ta.cube_vertices()),
        JAR.draw_ar_cube(img.copy(), np.eye(4), K, ja.cube_vertices()))
    assert not TAR.ARState().try_anchor(_Sys(None))


def test_render_ar_frame_matches_jax(six):
    """On the port's System: the port's anchor from its tracked points,
    and the overlay equal to the JAX function's on the same System (the
    JAX module reads the CPU tensors through numpy)."""
    sysm, frames = six
    ta, ja = TAR.ARState(), JAR.ARState()
    assert ta.try_anchor(sysm)
    assert ja.try_anchor(sysm)
    np.testing.assert_allclose(ta.anchor, ja.anchor, atol=1e-12)
    img = frames[-1][0]
    out = TAR.render_ar_frame(sysm, img, ta)
    np.testing.assert_array_equal(out, JAR.render_ar_frame(sysm, img, ja))
    assert (out != TD.render_current_frame(sysm, img)).any()   # cube drawn
