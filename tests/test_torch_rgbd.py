"""The PyTorch port's RGB-D path against the JAX package: the depth
lookup (`depth_from_rgbd`), the frame (`build_frame_rgbd`), the
frame step (`vo_frame_step_rgbd`) from a JAX state carried across with
`convert.py`, and `System.track_rgbd` over tests/test_e2e_rgbd.py's
forward sequence at its settings (the JAX package's defaults:
relocalization and loop detection on, mapping off), with the facade's
queries and timer rows after the same run; that file's holes-and-noise
run in both packages, and its DepthMapFactor run on the port.

Tolerances: validity masks, keypoint tables, landmark ids and counts
exact; depth and virtual right coordinates within rtol 1e-6; line
endpoints within 1e-3 px; frame-step poses within 1e-4 (float32 sums in
another order, and XLA's fused multiply-adds); System poses within 1e-3,
the stereo System test's tolerance (tests/test_torch_system.py);
ATE < 0.05 clean and < 0.08 with holes and noise (the JAX gates)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import ate_rmse, make_rgbd_sequence
from splslam_tpu.ops import stereo as JST
from splslam_tpu.slam import frame as JF
from splslam_tpu.slam import pipeline as JP
from splslam_tpu.slam import system as JS
from splslam_tpu_torch import convert
from splslam_tpu_torch.ops import stereo as TST
from splslam_tpu_torch.ops.pyramid import PyramidSpec
from splslam_tpu_torch.slam import frame as TF
from splslam_tpu_torch.slam import pipeline as TP
from splslam_tpu_torch.slam import system as TS

W, H = 320, 240
POSE_ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread beside the other test files' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def settings_kw(K, bf, **kw):
    """tests/test_e2e_rgbd.py::run_rgbd's settings."""
    return dict(dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), bf=float(bf), width=W, height=H,
                     n_features=600, n_levels=4, th_depth=40.0, fps=10,
                     max_points=8192, max_keyframes=64, local_window=1024,
                     enable_local_mapping=False), **kw)


class _Feat(NamedTuple):
    xy: np.ndarray
    valid: np.ndarray


def test_depth_from_rgbd_matches_jax():
    """Random keypoints (some off the image, some invalid), a depth map
    with holes, the TUM depth factor: the same mask, depth and virtual
    right coordinate."""
    rng = np.random.default_rng(5)
    n = 500
    xy = np.stack([rng.uniform(-3.0, W + 3.0, n), rng.uniform(-3.0, H + 3.0, n)],
                  -1).astype(np.float32)
    xy[:8] = [[0, 0], [W - 1, H - 1], [W - 0.5, 0], [0, H - 0.01],
              [-0.9, 5], [5, -0.9], [W + 2.5, H + 2.5], [12.999, 7.001]]
    valid = rng.uniform(size=n) > 0.1
    depth = (rng.uniform(0.5, 4.0, (H, W)) * 5000.0).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.25] = 0.0
    depth[0, 0] = 0.0
    bf, factor = 40.0, 1.0 / 5000.0
    ju, jd = JST.depth_from_rgbd(_Feat(jnp.asarray(xy), jnp.asarray(valid)),
                                 jnp.asarray(depth), bf, factor)
    tu, td = TST.depth_from_rgbd(_Feat(torch.from_numpy(xy), torch.from_numpy(valid)),
                                 torch.from_numpy(depth), bf, factor)
    ju, jd = np.asarray(ju), np.asarray(jd)
    np.testing.assert_array_equal(td.numpy() > 0, jd > 0)
    np.testing.assert_array_equal(tu.numpy() == -1.0, ju == -1.0)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6)
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-6)
    assert 200 < (jd > 0).sum() < 400


@pytest.mark.parametrize("dropout,line_capacity,texture", [
    (0.0, 1, "blobs"), (0.25, 1, "blobs"), (0.0, 64, "grid")])
def test_build_frame_rgbd_matches_jax(dropout, line_capacity, texture):
    K, bf, frames, _ = make_rgbd_sequence(n_frames=1, width=W, height=H,
                                          depth_dropout=dropout, texture=texture)
    img, depth = (np.asarray(x, np.float32) for x in frames[0])
    img = img.astype(np.uint8).astype(np.float32)
    kw = settings_kw(K, bf)
    spec = PyramidSpec.create(H, W, 4, 1.2, 600)
    factor = 1.0 / 5000.0
    jf = jax.device_get(JF.build_frame_rgbd(
        jnp.asarray(img), jnp.asarray(depth * 5000.0), JS.Settings(**kw).camera(),
        spec, depth_factor=factor, line_capacity=line_capacity))
    tf = TF.build_frame_rgbd(torch.from_numpy(img), torch.from_numpy(depth * 5000.0),
                             TS.Settings(**kw).camera(), spec, factor, line_capacity)
    for name in ("xy", "octave", "valid", "response", "sigma2"):
        np.testing.assert_array_equal(getattr(tf.feat, name).numpy(),
                                      np.asarray(getattr(jf.feat, name)), err_msg=name)
    np.testing.assert_array_equal(tf.feat.desc.numpy(),
                                  np.asarray(jf.feat.desc).view(np.int32))
    jd = np.asarray(jf.depth)
    np.testing.assert_array_equal(tf.depth.numpy() > 0, jd > 0)
    np.testing.assert_allclose(tf.depth.numpy(), jd, rtol=1e-6)
    np.testing.assert_allclose(tf.u_right.numpy(), np.asarray(jf.u_right), rtol=1e-6)
    n_depth = int((jd > 0).sum())
    assert n_depth > (400 if dropout == 0 else 300), n_depth
    v = np.asarray(jf.lines.valid)
    np.testing.assert_array_equal(tf.lines.valid.numpy(), v)
    if line_capacity > 1:
        np.testing.assert_array_equal(tf.lines.octave.numpy(), np.asarray(jf.lines.octave))
        np.testing.assert_allclose(tf.lines.seg.numpy()[v], np.asarray(jf.lines.seg)[v],
                                   atol=1e-3)
        assert v.sum() >= 10


# ---------------------------------------------------------------------
# the JAX System over tests/test_e2e_rgbd.py's forward sequence, once
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def scene():
    return make_rgbd_sequence(n_frames=20, motion="forward", width=W, height=H)


N_SNAP = 12   # frames tracked before the frame-step comparison


@pytest.fixture(scope="module")
def jax_run(scene):
    """The JAX System's run; its map and tracker state after frame
    N_SNAP - 1 are kept (`js.snap`) for the frame-step comparison."""
    K, bf, frames, gt = scene
    js = JS.System(JS.Settings(**settings_kw(K, bf)), JS.Sensor.RGBD)
    for i, (img, depth) in enumerate(frames):
        js.track_rgbd(img, depth, i * 0.1)
        if i == N_SNAP - 1:
            js.snap = (jax.device_get(js.map), jax.device_get(js.step), js.ref_kf)
    js.drain()
    return js


@pytest.fixture(scope="module")
def port_run(scene):
    K, bf, frames, gt = scene
    ts = TS.System(TS.Settings(**settings_kw(K, bf)), TS.Sensor.RGBD, "cpu")
    for i, (img, depth) in enumerate(frames):
        ts.track_rgbd(img, depth, i * 0.1)
    ts.drain()
    return ts


def test_rgbd_system_constructs():
    """An RGB-D System constructs with the JAX defaults and waits for its
    first frame."""
    sysm = TS.System(TS.Settings(), TS.Sensor.RGBD, "cpu")
    assert sysm.sensor == TS.Sensor.RGBD and sysm.vocab is not None
    assert sysm.get_tracking_state() == TS.TrackingState.NO_IMAGES_YET


def test_rgbd_system_follows_jax(scene, jax_run, port_run):
    """The same keyframes and landmarks as the JAX run (with the stereo
    keyframe policy: the monocular one inserts others), poses within the
    stereo System test's tolerance, ATE < 0.05."""
    _, _, _, gt = scene
    ts, js = port_run, jax_run
    assert ts.get_tracking_state() == TS.TrackingState.OK
    assert not any(e.lost for e in ts.trajectory)
    assert ts.n_kfs == js.n_kfs >= 1
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert ts.n_pts == js.n_pts
    pt, pj = ts.poses(), js.poses()
    assert pt.shape == pj.shape == gt.shape
    np.testing.assert_allclose(pt[:, :3, :4], pj[:, :3, :4], atol=POSE_ATOL)
    assert ate_rmse(pt, gt) < 0.05


def test_tracked_points_and_keypoints_follow_jax(jax_run, port_run):
    tp, jp = port_run.get_tracked_map_points(), jax_run.get_tracked_map_points()
    assert tp.shape == jp.shape and tp.shape[0] > 100
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    tk, jk = port_run.get_tracked_keypoints(), jax_run.get_tracked_keypoints()
    assert tk.shape == jk.shape == (port_run.spec.total_capacity, 2)
    np.testing.assert_array_equal(tk, jk)


@pytest.fixture(scope="module")
def kf_runs(scene):
    """Both packages over the first 8 frames with a keyframe every 2
    frames (relocalization off, loop detection on): RGB-D keyframes with
    stereo landmark creation, and every timer row. ThDepth 80 (9.6 m): at
    40 nearly every untracked keypoint of this scene lies beyond the 4.8 m
    that bounds landmark creation."""
    K, bf, frames, _ = scene
    kw = settings_kw(K, bf, force_kf_every=2, enable_relocalization=False,
                     th_depth=80.0)
    runs = []
    for sysm in (TS.System(TS.Settings(**kw), TS.Sensor.RGBD, "cpu"),
                 JS.System(JS.Settings(**kw), JS.Sensor.RGBD)):
        for i, (img, depth) in enumerate(frames[:8]):
            sysm.track_rgbd(img, depth, i * 0.1)
        sysm.shutdown()
        runs.append(sysm)
    return runs


def test_rgbd_keyframes_create_landmarks_as_jax(kf_runs):
    ts, js = kf_runs
    assert ts.n_kfs == js.n_kfs >= 3
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert ts.n_pts == js.n_pts > 600   # the keyframes created landmarks


@pytest.mark.parametrize("which", ["tracking only", "keyframes"])
def test_timer_rows_follow_jax(which, jax_run, port_run, kf_runs):
    """`timers.report()` has the JAX System's rows, in its order and with
    its counts, and `shutdown` leaves nothing in flight."""
    ts, js = (port_run, jax_run) if which == "tracking only" else kf_runs
    ts.shutdown()
    tr, jr = ts.timers.report(), js.timers.report()
    assert list(tr) == list(jr)
    assert [r["n"] for r in tr.values()] == [r["n"] for r in jr.values()]
    assert "Tracking total / frame" in tr
    if which == "keyframes":
        assert {"KeyFrame insertion", "Mapping total / keyframe",
                "Loop detection / keyframe"} <= set(tr)
    assert not ts._pending and ts.mapper._pending is None
    assert "Tracking total / frame" in ts.timers.pretty()


def test_vo_frame_step_rgbd_matches_jax(scene, jax_run, monkeypatch):
    """Three frames from the JAX run's state after frame N_SNAP - 1, each
    side carrying its own state: counts and landmark ids exact, poses
    within 1e-4. The reference builds its frames op by op: under jit,
    XLA's fused multiply-adds move the pyramid's levels by ~3e-5, which
    moves a FAST score across a tie on frame 14 and reorders its keypoint
    table (the port computes the eager reference's values)."""
    build = JF.build_frame_rgbd

    def build_op_by_op(*args, **kw):
        with jax.disable_jit():
            return build(*args, **kw)

    monkeypatch.setattr(JF, "build_frame_rgbd", build_op_by_op)
    K, bf, frames, _ = scene
    js = jax_run
    snap_map, snap_step, ref_kf = js.snap
    jm = jax.tree.map(jnp.array, snap_map)
    jstep = jax.tree.map(jnp.array, snap_step)
    tmap = convert.map_state_from_numpy(jax.tree.map(np.array, snap_map), "cpu")
    tstep = convert.step_state_from_numpy(jax.tree.map(np.array, snap_step), "cpu")
    scales = np.asarray(js.spec.scales, np.float32)
    tcam = TS.Settings(**settings_kw(K, bf)).camera()
    for img, depth in frames[N_SNAP:N_SNAP + 3]:
        img = np.asarray(img).astype(np.uint8)
        depth = np.asarray(depth, np.float32)
        jm, jstep, jstats = JP.vo_frame_step_rgbd(
            jnp.asarray(img), jnp.asarray(depth), jm, jstep,
            jnp.float32(js.th_depth_m), jnp.int32(ref_kf), js.cam, js.spec,
            jnp.asarray(scales), m_local=1024, scale_factor=1.2, n_levels=4,
            line_capacity=1)
        tmap, tstep, tstats = TP.vo_frame_step_rgbd(
            torch.from_numpy(img), torch.from_numpy(depth), tmap, tstep,
            js.th_depth_m, ref_kf, tcam, PyramidSpec.create(H, W, 4, 1.2, 600),
            torch.from_numpy(scales), m_local=1024, scale_factor=1.2, n_levels=4,
            line_capacity=1)
        jstats = np.asarray(jstats)
        np.testing.assert_array_equal(tstats.numpy()[16:], jstats[16:])
        np.testing.assert_allclose(tstats.numpy()[:16], jstats[:16], atol=1e-4)
        np.testing.assert_array_equal(tstep.lm_gid.numpy(), np.asarray(jstep.lm_gid))
        assert jstats[TP.S_N_IN] > 100
    for f in ("n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(tmap.pts, f).numpy(),
                                      np.asarray(getattr(jm.pts, f)), err_msg=f)


def _rgbd_run(S, scale: float, **seq_kw):
    """A System of package `S` (the port's on the CPU) over the forward
    sequence, depth fed in units of 1/scale m (relocalization and loop
    detection off). Returns (system, ATE)."""
    K, bf, frames, gt = make_rgbd_sequence(n_frames=seq_kw.pop("n_frames", 20),
                                           motion="forward", width=W, height=H,
                                           **seq_kw)
    kw = settings_kw(K, bf, enable_relocalization=False, enable_loop_closing=False)
    if scale != 1.0:
        kw["depth_map_factor"] = 1.0 / scale
    sysm = (TS.System(TS.Settings(**kw), TS.Sensor.RGBD, "cpu") if S is TS
            else S.System(S.Settings(**kw), S.Sensor.RGBD))
    for i, (img, depth) in enumerate(frames):
        sysm.track_rgbd(img, np.asarray(depth) * scale, i * 0.1)
    sysm.drain()
    assert sysm.get_tracking_state().name == "OK"
    return sysm, ate_rmse(sysm.poses(), gt)


def test_sensor_holes_and_noise():
    """tests/test_e2e_rgbd.py's structured-light run: 25% depth holes and
    2% multiplicative noise; keypoints in holes stay depth-less. The
    stereo keyframe policy inserts a second keyframe here (the monocular
    one does not): the same keyframes and landmarks as the JAX run."""
    ts, ate = _rgbd_run(TS, 1.0, depth_dropout=0.25, depth_noise=0.02)
    js, _ = _rgbd_run(JS, 1.0, depth_dropout=0.25, depth_noise=0.02)
    assert ate < 0.08
    assert ts.n_kfs == js.n_kfs >= 2
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert ts.n_pts == js.n_pts


def test_depth_map_factor():
    """TUM depth units: depth x 5000 in, DepthMapFactor 5000 (a factor of
    1/5000) applied by the System."""
    assert _rgbd_run(TS, 5000.0, n_frames=10)[1] < 0.05
