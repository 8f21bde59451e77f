"""The PyTorch port's stereo slice as a whole, against the JAX System on
the same 20-frame forward sequence as tests/test_e2e_stereo.py: tracking
alone (local mapping, relocalization and loop closing off on both sides),
and with local mapping on at the reference's pinned keyframe cadence
(`force_kf_every=4`, tests/test_e2e_parity.py). With the JAX defaults
(relocalization and loop detection on): the kidnap of
tests/test_reloc.py, a map saved and reloaded, and maps carried between
the two packages by `save_map` / `load_map`.

Gates: state OK and ATE < 0.05 (the JAX gate); the same keyframes (and,
with mapping, the same number of mapping steps) as the JAX run;
per-frame poses within 1e-3 (translation, and rotation matrix entries)
of the JAX run — float32 differences accumulate over the sequence
(measured max 8.1e-6 translation without mapping, 3.4e-4 with it: local
BA moves the keyframe poses the frames are tracked against); no
non-finite BA revert (`mapping_state_revert == 0`) on either side;
equal trajectory export line counts; after a kidnap, the replayed view
relocalizes within 0.05 m of ground truth (the JAX gate). Lines
construct with every back-end stage, and loop correction is a setting
(tests/test_torch_correction.py drives it); RGB-D and the text
vocabulary are tested in tests/test_torch_rgbd.py and
tests/test_torch_config.py. `build_frame_stereo` and `build_frame_mono`
with lines against the reference's, and the point+line lost gate's
truth table (tests/test_track_gates.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import ate_rmse, make_stereo_sequence
from splslam_tpu.slam import system as JS
from splslam_tpu_torch.bow import vocabulary as TV
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


# the settings of the JAX-vs-port fixtures: relocalization and loop
# closing off on both sides, so their numbers keep their meaning
NO_RELOC = dict(enable_relocalization=False, enable_loop_closing=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside the other test files' workers, torch's own thread pool only
    oversubscribes the cores (PERF.md §7's CPU note): one thread, as the
    other heavy parity files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    kw = dict(settings_kw(K, bf), enable_local_mapping=False, **NO_RELOC)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw), JS.Sensor.STEREO)
    for sysm in (ts, js):
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        sysm.drain()
    return ts, js, gt


@pytest.fixture(scope="module")
def mapping_runs():
    K, bf, frames, gt = make_stereo_sequence(n_frames=20, motion="forward",
                                             width=320, height=240)
    kw = dict(settings_kw(K, bf), force_kf_every=4, **NO_RELOC)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw), JS.Sensor.STEREO)
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
    kw = dict(settings_kw(K, bf), enable_local_mapping=False, **NO_RELOC,
              **policy)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw), JS.Sensor.STEREO)
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


@pytest.mark.parametrize("case", [
    # tests/test_track_gates.py: (n_in, n_ln_in, using_line, recent, lost)
    (9, 0, False, False, True), (10, 0, False, False, False), (9, 99, False, False, True),
    (12, 0, True, False, False), (0, 12, True, False, False), (5, 7, True, False, False),
    (5, 6, True, False, True), (11, 0, True, False, True), (28, 0, True, False, False),
    (21, 12, True, False, False), (29, 14, True, True, True), (30, 0, True, True, False),
    (0, 15, True, True, False), (29, 14, True, False, False),
])
def test_track_lost_dual_gate(case):
    """The point+line lost gate's truth table (reference TrackLocalMapBoth
    accept cascade, src/Tracking.cc:2097-2108)."""
    n_in, n_ln, using_line, recent, lost = case
    assert TS.track_lost(n_in, n_ln, using_line, recent) is lost


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


NO_STAGES = dict(enable_local_mapping=False, **NO_RELOC)


@pytest.mark.parametrize("change", [
    dict(sensor=TS.Sensor.MONOCULAR),
    dict(NO_STAGES, sensor=TS.Sensor.MONOCULAR, using_line=True),
    dict(NO_STAGES, using_line=True),
    # lines with the back end: the JAX defaults, and each stage alone
    dict(using_line=True),
    dict(NO_STAGES, using_line=True, enable_local_mapping=True),
    dict(NO_STAGES, using_line=True, enable_relocalization=True),
    dict(NO_STAGES, using_line=True, enable_loop_closing=True),
    dict(NO_STAGES, using_line=True, enable_loop_correction=True),
    dict(NO_STAGES, sensor=TS.Sensor.MONOCULAR, using_line=True,
         enable_local_mapping=True),
])
def test_mono_and_lines_construct(change):
    change = dict(change)
    sensor = change.pop("sensor", TS.Sensor.STEREO)
    sysm = TS.System(TS.Settings(**change), sensor, "cpu")
    cap = sysm.settings.line_features if sysm.settings.using_line else 1
    assert sysm.line_cap == cap == sysm.map.kfs.lseg.shape[1]
    assert sysm.line_cfg == ("grow", 2, 24.0)
    assert sysm.get_tracking_state() == TS.TrackingState.NO_IMAGES_YET


def test_loop_correction_is_a_setting_not_a_later_slice():
    """`enable_loop_correction=True` constructs (stereo, points); the
    default stays the reference's kill-switch."""
    assert TS.Settings().enable_loop_correction is False
    sysm = TS.System(TS.Settings(enable_loop_correction=True,
                                 enable_relocalization=False),
                     TS.Sensor.STEREO, "cpu")
    assert sysm.settings.enable_loop_correction and not sysm.map_changed()
    h = sysm.health()
    assert h["loop_corrections"] == 0 and h["loop_guarded"] == 0


@pytest.mark.parametrize("backend", ["grow", "fld"])
def test_frame_with_lines_matches_jax(backend):
    """build_frame_stereo with a line table (lines from the left image)
    against the reference's: points and stereo as before, line validity
    and octaves exact, endpoints within 2e-3 px (tests/test_torch_lines.py)."""
    from splslam_tpu.slam import frame as JF

    K, bf, frames, _ = make_stereo_sequence(n_frames=1, motion="lateral",
                                            width=320, height=240, texture="grid")
    l, r = (np.asarray(x, np.float32) for x in frames[0])
    jcam = JS.Settings(**settings_kw(K, bf)).camera()
    tcam = TS.Settings(**settings_kw(K, bf)).camera()
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    cfg = (backend, 2, 24.0)
    jf = jax.device_get(JF.build_frame_stereo(jnp.asarray(l), jnp.asarray(r), jcam,
                                              spec, line_capacity=32, line_cfg=cfg))
    tf = TF.build_frame_stereo(torch.from_numpy(l), torch.from_numpy(r), tcam, spec,
                               torch.tensor(spec.scales), line_capacity=32, line_cfg=cfg)
    np.testing.assert_array_equal(tf.feat.desc.numpy(), np.asarray(jf.feat.desc).view(np.int32))
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth), atol=1e-4)
    v = np.asarray(jf.lines.valid)
    np.testing.assert_array_equal(tf.lines.valid.numpy(), v)
    np.testing.assert_array_equal(tf.lines.octave.numpy(), np.asarray(jf.lines.octave))
    np.testing.assert_allclose(tf.lines.seg.numpy()[v], np.asarray(jf.lines.seg)[v], atol=2e-3)
    assert v.sum() >= 10


def test_build_frame_mono_matches_jax():
    """build_frame_mono with lines and undistortion, against the reference."""
    from splslam_tpu.slam import frame as JF

    K, bf, frames, _ = make_stereo_sequence(n_frames=1, motion="lateral",
                                            width=320, height=240, texture="grid")
    img = np.asarray(frames[0][0], np.float32)
    kw = dict(settings_kw(K, 0.0), k1=-0.05, k2=0.01)
    spec = PyramidSpec.create(240, 320, 4, 1.2, 600)
    jf = jax.device_get(JF.build_frame_mono(jnp.asarray(img), JS.Settings(**kw).camera(),
                                            spec, undistort=True, with_lines=True,
                                            line_capacity=32))
    tf = TF.build_frame_mono(torch.from_numpy(img), TS.Settings(**kw).camera(), spec,
                             undistort=True, with_lines=True, line_capacity=32)
    np.testing.assert_array_equal(tf.feat.valid.numpy(), np.asarray(jf.feat.valid))
    np.testing.assert_allclose(tf.feat.xy.numpy(), np.asarray(jf.feat.xy), atol=1e-3)
    assert (tf.u_right.numpy() == -1).all() and (tf.depth.numpy() == -1).all()
    v = np.asarray(jf.lines.valid)
    np.testing.assert_array_equal(tf.lines.valid.numpy(), v)
    for f in ("seg", "midpoint", "length"):
        np.testing.assert_allclose(getattr(tf.lines, f).numpy()[v],
                                   np.asarray(getattr(jf.lines, f))[v], atol=2e-3)


def test_settings_defaults_match_jax():
    for name in ("enable_relocalization", "vocabulary_path", "reloc_min_inliers",
                 "enable_loop_closing", "enable_loop_correction",
                 "enable_local_mapping", "min_kf_gap", "async_depth",
                 "using_line", "line_features", "using_lsd", "line_n_levels",
                 "line_min_length_ratio"):
        assert getattr(TS.Settings(), name) == getattr(JS.Settings(), name), name


def _kidnap(sysm, frames, gt, view):
    """Track, kidnap with 3 blank frames, replay a seen view twice."""
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    blank = np.full((240, 320), 128.0, np.float32)
    for j in range(3):
        sysm.track_stereo(blank, blank, 1.5 + j * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.LOST
    for j in range(2):
        sysm.track_stereo(frames[view][0], frames[view][1], 2.0 + j * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    p = sysm.poses()[-1][:3, 3]
    assert np.linalg.norm(p - gt[view][:3, 3]) < 0.05, p


def test_relocalization_after_kidnap():
    """tests/test_reloc.py's kidnap, for the port: relocalization and loop
    detection on (the defaults), local mapping on. As in the JAX package,
    the blank frames run relocalization attempts that find nothing, and
    the replayed view is recovered by the reference-keyframe fallback."""
    K, bf, frames, gt = make_stereo_sequence(n_frames=15, motion="forward",
                                             width=320, height=240)
    sysm = TS.System(TS.Settings(**settings_kw(K, bf)), TS.Sensor.STEREO, "cpu")
    assert sysm.vocab is not None and sysm.vocab.n_words == 10 ** 5
    _kidnap(sysm, frames, gt, view=6)
    # every keyframe has a BoW row; the relocalized frame is logged OK
    W = sysm.bow_n_words
    assert all((sysm.kf_bow.ids[k] < W).any() for k in range(sysm.n_kfs))
    assert not sysm.trajectory[-1].lost and sysm.trajectory[-3].lost
    assert all(v == 0 for k, v in sysm.health().items() if k.startswith("loop"))
    assert sysm.health()["verified_loops"] == 0


def _save_reload(frames, save, load, tmp_path):
    path = str(tmp_path / "map.npz")
    save.save_map(path)
    load.load_map(path)
    assert load.get_tracking_state().name == "LOST"   # either package's enum
    assert load.n_kfs == save.n_kfs >= 2
    for j in range(2):
        load.track_stereo(frames[5][0], frames[5][1], 5.0 + j * 0.1)
    load.drain()
    # with no tracker state every frame goes straight to relocalization
    assert load._last_reloc_fid >= 0 and load.step is None
    return load.poses()[-1][:3, 3]


def test_map_save_load_relocalize(tmp_path):
    """tests/test_reloc.py's checkpoint round trip, for the port."""
    K, bf, frames, gt = make_stereo_sequence(n_frames=12, motion="forward",
                                             width=320, height=240)
    st = TS.Settings(**settings_kw(K, bf))
    s1 = TS.System(st, TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames):
        s1.track_stereo(l, r, i * 0.1)
    s2 = TS.System(st, TS.Sensor.STEREO, "cpu")
    pos = _save_reload(frames, s1, s2, tmp_path)
    assert s2.state == TS.TrackingState.OK
    assert np.linalg.norm(pos - gt[5][:3, 3]) < 0.05
    torch.testing.assert_close(s2.kf_bow.ids, s1.kf_bow.ids, rtol=0, atol=0)
    torch.testing.assert_close(s2.map.kfs.desc, s1.map.kfs.desc, rtol=0, atol=0)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_map_cross_loads_between_packages(direction, tmp_path):
    """A map saved by one package's System loads into the other's, which
    then relocalizes into it (same `.npz` keys, uint32 descriptors)."""
    K, bf, frames, gt = make_stereo_sequence(n_frames=12, motion="forward",
                                             width=320, height=240)
    kw = settings_kw(K, bf)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    js = JS.System(JS.Settings(**kw), JS.Sensor.STEREO)
    src, dst = (js, ts) if direction == "jax_to_port" else (ts, js)
    for i, (l, r) in enumerate(frames):
        src.track_stereo(l, r, i * 0.1)
    pos = _save_reload(frames, src, dst, tmp_path)
    assert dst.state.name == "OK"
    assert np.linalg.norm(pos - gt[5][:3, 3]) < 0.05
    z = np.load(str(tmp_path / "map.npz"))
    assert z["kfs.desc"].dtype == np.uint32 and z["pts.desc"].dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(dst.kf_bow.ids),
                                  np.asarray(src.kf_bow.ids))


def test_load_map_dense_bow_backcompat(tmp_path):
    """tests/test_reloc.py's case for the port: a checkpoint written before
    the sparse BowTable holds a dense [K, W] `meta.kf_bow`; load_map
    compacts it into the sparse rows a fresh save would hold."""
    st = TS.Settings(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=32.0,
                     width=320, height=240, n_features=256, max_points=1024,
                     max_keyframes=8, local_window=256)
    s1 = TS.System(st, TS.Sensor.STEREO, "cpu")
    W = s1.bow_n_words
    ids, vals = s1.kf_bow
    ids[0, :3] = torch.tensor([5, 17, W - 1], dtype=torch.int32)
    vals[0, :3] = torch.tensor([0.5, 0.25, 0.25])
    ids[1, :2] = torch.tensor([17, 42], dtype=torch.int32)
    vals[1, :2] = torch.tensor([0.75, 0.25])
    p = str(tmp_path / "map.npz")
    s1.save_map(p)
    z = dict(np.load(p))
    dense = np.zeros((st.max_keyframes, W), np.float32)
    for k in range(2):
        live = vals[k].numpy() > 0
        dense[k, ids[k].numpy()[live]] = vals[k].numpy()[live]
    del z["meta.kf_bow_ids"], z["meta.kf_bow_vals"]
    z["meta.kf_bow"] = dense
    np.savez_compressed(p, **z)
    s2 = TS.System(st, TS.Sensor.STEREO, "cpu")
    s2.load_map(p)
    for k in range(2):
        got = TV.densify_bow_row(s2.kf_bow.ids, s2.kf_bow.vals, k, W).numpy()
        np.testing.assert_allclose(got, dense[k], atol=1e-7)
    torch.testing.assert_close(s2.kf_bow.ids, s1.kf_bow.ids, rtol=0, atol=0)
