"""The PyTorch port's stereo slice as a whole, against the JAX System on
the same 20-frame forward sequence as tests/test_e2e_stereo.py: tracking
alone (local mapping and relocalization off on both sides), and with
local mapping on at the reference's pinned keyframe cadence
(`force_kf_every=4`, tests/test_e2e_parity.py).

Gates: state OK and ATE < 0.05 (the JAX gate); the same keyframes (and,
with mapping, the same number of mapping steps) as the JAX run;
per-frame poses within 1e-3 (translation, and rotation matrix entries)
of the JAX run — float32 differences accumulate over the sequence
(measured max 8.1e-6 translation without mapping, 3.4e-4 with it: local
BA moves the keyframe poses the frames are tracked against); no
non-finite BA revert (`mapping_state_revert == 0`) on either side;
equal trajectory export line counts. Slice limits raise
NotImplementedError."""

import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import ate_rmse, make_stereo_sequence
from splslam_tpu.slam import system as JS
from splslam_tpu_torch.geometry.camera import Camera
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.slam import frame as TF
from splslam_tpu_torch.slam import system as TS

POSE_ATOL = 1e-3


def settings_kw(K, bf):
    return dict(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
        n_features=600, n_levels=4, th_depth=40.0, fps=10,
        max_points=8192, max_keyframes=64, local_window=1024,
    )


@pytest.fixture(scope="module")
def runs():
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    kw = dict(settings_kw(K, bf), enable_local_mapping=False)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw, enable_relocalization=False), JS.Sensor.STEREO)
    for sysm in (ts, js):
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        sysm.drain()
    return ts, js, gt


@pytest.fixture(scope="module")
def mapping_runs():
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    kw = dict(settings_kw(K, bf), force_kf_every=4)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw, enable_relocalization=False), JS.Sensor.STEREO)
    for sysm in (ts, js):
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        sysm.drain()
    return ts, js, gt


def test_port_tracks_with_low_ate(runs):
    ts, _, gt = runs
    assert ts.get_tracking_state() == TS.TrackingState.OK
    est = ts.poses()
    assert est.shape == gt.shape
    assert not any(e.lost for e in ts.trajectory)
    assert ate_rmse(est, gt) < 0.05


def test_same_keyframes_as_jax(runs):
    ts, js, _ = runs
    assert ts.n_kfs == js.n_kfs >= 2
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert ts.n_pts == js.n_pts


def test_poses_follow_jax(runs):
    ts, js, _ = runs
    pt, pj = ts.poses(), js.poses()
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=POSE_ATOL)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=POSE_ATOL)


def test_trajectory_export(runs, tmp_path):
    ts, js, gt = runs
    counts = []
    for name, sysm in (("torch", ts), ("jax", js)):
        tum, kitti = tmp_path / f"{name}.tum", tmp_path / f"{name}.kitti"
        sysm.save_trajectory_tum(str(tum))
        sysm.save_trajectory_kitti(str(kitti))
        tl = tum.read_text().strip().split("\n")
        kl = kitti.read_text().strip().split("\n")
        assert len(tl[0].split()) == 8 and len(kl[0].split()) == 12
        counts.append((len(tl), len(kl)))
    assert counts[0] == counts[1] == (len(gt), len(gt))
    a = np.loadtxt(tmp_path / "torch.kitti")
    b = np.loadtxt(tmp_path / "jax.kitti")
    np.testing.assert_allclose(a, b, atol=POSE_ATOL)


def test_mapping_run_follows_jax(mapping_runs):
    ts, js, gt = mapping_runs
    assert ts.settings.enable_local_mapping and js.settings.enable_local_mapping
    assert ts.get_tracking_state() == TS.TrackingState.OK
    assert not any(e.lost for e in ts.trajectory)
    assert ts.n_kfs == js.n_kfs >= 4
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    np.testing.assert_array_equal(ts.map.kfs.valid[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.valid[:js.n_kfs]))
    assert ts.mapper.n_steps == js.mapper.n_steps == ts.n_kfs - 1
    assert ts.n_pts == js.n_pts
    pt, pj = ts.poses(), js.poses()
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=POSE_ATOL)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=POSE_ATOL)
    assert ate_rmse(pt, gt) < 0.05


def test_mapping_health_matches_jax(mapping_runs):
    ts, js, _ = mapping_runs
    th, jh = ts.health(), js.health()
    for k in th:
        assert th[k] == jh[k], k
    assert th["mapping_state_revert"] == 0
    assert th["mapping_steps"] == ts.mapper.n_steps
    # the post-BA keyframe poses reached the host log (one step late)
    for kf, pose in ts.kf_pose_host.items():
        np.testing.assert_allclose(pose, js.kf_pose_host[kf], atol=POSE_ATOL)


def test_mapping_trajectory_export(mapping_runs, tmp_path):
    ts, js, gt = mapping_runs
    for name, sysm in (("torch", ts), ("jax", js)):
        sysm.save_trajectory_kitti(str(tmp_path / f"{name}.kitti"))
    a = np.loadtxt(tmp_path / "torch.kitti")
    b = np.loadtxt(tmp_path / "jax.kitti")
    assert a.shape == b.shape == (len(gt), 12)
    np.testing.assert_allclose(a, b, atol=POSE_ATOL)


@pytest.mark.parametrize("policy", [dict(force_kf_every=4),
                                    dict(min_kf_gap=100), dict(async_depth=2)])
def test_keyframe_policy_knobs_match_jax(policy):
    """Lateral motion never fires the faithful c2 on this scene, so every
    keyframe after the first comes from the knob under test."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=13, motion="lateral",
                                            width=320, height=240)
    kw = dict(settings_kw(K, bf), enable_local_mapping=False, **policy)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw, enable_relocalization=False), JS.Sensor.STEREO)
    for sysm in (ts, js):
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        sysm.drain()
    assert ts.get_tracking_state() == TS.TrackingState.OK
    assert ts.n_kfs == js.n_kfs
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    if "force_kf_every" in policy:
        assert 3 <= ts.n_kfs <= 4
    np.testing.assert_allclose(ts.poses()[:, :3, 3], js.poses()[:, :3, 3],
                               atol=POSE_ATOL)


@pytest.mark.parametrize("using_line", [False, True])
def test_track_lost_matches_jax(using_line):
    for n_in in range(0, 40, 3):
        for n_ln in range(0, 20, 4):
            for recent in (False, True):
                assert TS.track_lost(n_in, n_ln, using_line, recent) == \
                    JS.track_lost(n_in, n_ln, using_line, recent)


def test_reset(runs):
    K, bf, frames, _ = make_stereo_sequence(n_frames=3, motion="lateral",
                                            width=320, height=240)
    sysm = TS.System(TS.Settings(**settings_kw(K, bf)), TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    sysm.reset()
    assert sysm.get_tracking_state() == TS.TrackingState.NO_IMAGES_YET
    assert sysm.n_kfs == 0 and len(sysm.trajectory) == 0


@pytest.mark.parametrize("change", [
    dict(sensor=TS.Sensor.MONOCULAR), dict(sensor=TS.Sensor.RGBD),
    dict(using_line=True), dict(enable_relocalization=True),
    dict(enable_loop_closing=True),
])
def test_later_slices_raise(change):
    change = dict(change)
    sensor = change.pop("sensor", TS.Sensor.STEREO)
    with pytest.raises(NotImplementedError):
        TS.System(TS.Settings(**change), sensor, "cpu")


def test_frame_with_lines_raises():
    img = torch.zeros((240, 320))
    with pytest.raises(NotImplementedError, match="line pipeline"):
        TF.build_frame_stereo(img, img, Camera.create(200, 200, 160, 120, bf=24),
                              PyramidSpec.create(240, 320, 4, 1.2, 600),
                              line_capacity=8)
