"""The monocular path of the PyTorch port (`slam/mono.py`, `slam/initializer.py`,
`pipeline.vo_frame_step_mono`, `System.track_mono`) against the JAX
reference, on the synthetic grid sequence at 320x240 (lateral motion,
the scene of tests/test_e2e_mono.py's point+line case) with 64 line
slots; and a monocular points-only run with local mapping on.

The reference draws its RANSAC hypotheses with `jax.random`; the port's
come from one module-level function, `mono.draw_init_samples`, which the
System comparison replaces by the reference's own draws (its Gumbel
top-k from PRNGKey(0), recomputed from the same mask), so both runs see
the same hypotheses.

Gates: matches, landmark and map-line ids, validity and observation
counts exact; landmark positions within a relative 1e-3 (the mono scale
gauge: the map is normalised by a median depth, so an ulp there scales
everything after it), map-line points within 1e-3 off the reference's
3D line (the init BA's line edges leave them free along it); the init pose within 1e-3; one tracked frame's
counts exact and its pose within 1e-4; over the whole System run the
same init frame, `init_used_h` and keyframes, per-frame poses within
2e-2 (translation and rotation entries; they agree to 1e-4 for the first
13 frames, then one borderline point inlier flips and the two runs drift
apart by up to 6e-3), the line inliers of every tracked frame equal,
and the Sim3-aligned ATE under 0.15
(tests/test_e2e_mono.py's gate). The points-only run with mapping:
ATE < 0.1 and no non-finite BA revert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import ate_rmse, make_stereo_sequence
from splslam_tpu.slam import frame as JF
from splslam_tpu.slam import mono as JM
from splslam_tpu.slam import system as JS
from splslam_tpu.slam.initializer import two_view_init as j_two_view_init
from splslam_tpu.slam.map import MapState as JMapState
from splslam_tpu_torch import convert
from splslam_tpu_torch.slam import map as TMap
from splslam_tpu_torch.slam import mono as TM
from splslam_tpu_torch.slam import pipeline as TP
from splslam_tpu_torch.slam import system as TS

N_FRAMES = 18
POSE_ATOL = 2e-2


def jax_samples(mask: torch.Tensor, n_hyp: int = 256) -> torch.Tensor:
    """The reference's hypotheses for `mask` (initializer.py:294-296)."""
    m = jnp.asarray(mask.cpu().numpy())
    g = jax.random.gumbel(jax.random.PRNGKey(0), (n_hyp, m.shape[0])) \
        + jnp.where(m, 0.0, -1e9)[None]
    return torch.from_numpy(np.asarray(jax.lax.top_k(g, 8)[1]).astype(np.int64))


def settings_kw(K, **kw):
    return dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                cy=float(K[1, 2]), bf=0.0, width=320, height=240,
                n_features=600, n_levels=4, fps=10, max_points=8192,
                max_keyframes=64, local_window=1024, **kw)


LINES_KW = dict(using_line=True, line_features=64, enable_local_mapping=False,
                enable_relocalization=False, enable_loop_closing=False)


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    K, _, frames, gt = make_stereo_sequence(n_frames=N_FRAMES, motion="lateral",
                                            width=320, height=240, texture="grid")
    kw = settings_kw(K, **LINES_KW)
    js = JS.System(JS.Settings(**kw), JS.Sensor.MONOCULAR)
    ts = TS.System(TS.Settings(**kw), TS.Sensor.MONOCULAR, "cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(TM, "draw_init_samples", jax_samples)
    try:
        for sysm in (js, ts):
            record_line_inliers(sysm)
            for i, (l, _) in enumerate(frames):
                sysm.track_mono(l, i * 0.1)
            sysm.drain()
    finally:
        mp.undo()
    return js, ts, frames, gt


def record_line_inliers(sysm):
    """Keep each consumed frame's line-inlier count in `sysm.ln_in`."""
    sysm.ln_in = []
    consume = sysm._process_one

    def process_one():
        sysm.ln_in.append(int(np.asarray(sysm._pending[0][0])[TP.S_N_LN_IN]))
        consume()

    sysm._process_one = process_one


class Init:
    """The reference's two-view bootstrap inputs and result, as numpy."""


def _init_inputs(js, frames, with_lines: bool) -> Init:
    """Rebuild the frames the reference initialized from and run its
    matchers and two-view RANSAC on them."""
    r = Init()
    r.i1 = int(round(js.trajectory[0].ts / 0.1))
    r.i2 = int(round(js.trajectory[1].ts / 0.1))
    cap = 64 if with_lines else 1
    build = lambda i: JF.build_frame_mono(
        jnp.asarray(frames[i][0], jnp.float32), js.cam, js.spec,
        with_lines=with_lines, line_capacity=cap)
    f1, f2 = build(r.i1), build(r.i2)
    m12, _ = JM.match_for_initialization(f1, f2)
    if with_lines:
        m12L, _ = JM.match_lines_for_initialization(f1, f2)
    else:
        m12L = jnp.full((cap,), -1, jnp.int32)
    N = f1.feat.capacity
    ok_p, ok_l = m12 >= 0, m12L >= 0
    xy1 = jnp.concatenate([f1.feat.xy, f1.lines.midpoint])
    xy2 = jnp.concatenate([f2.feat.xy[jnp.clip(m12, 0)],
                           f2.lines.midpoint[jnp.clip(m12L, 0)]])
    ok = jnp.concatenate([ok_p, ok_l])
    inv_s2 = jnp.concatenate([jnp.ones((N,)), jnp.full((cap,), 1.0 / 9.0)])
    res = j_two_view_init(jax.random.PRNGKey(0), xy1, xy2, ok, js.cam.K,
                          inv_sigma2=inv_s2)
    r.f1, r.f2, r.m12, r.m12L, r.res = jax.device_get((f1, f2, m12, m12L, res))
    r.N = N
    return r


@pytest.fixture(scope="module")
def init_lines(runs):
    js, _, frames, _ = runs
    return _init_inputs(js, frames, with_lines=True)


def test_init_matchers_match_jax(init_lines):
    r = init_lines
    f1 = convert.frame_from_numpy(r.f1, "cpu")
    f2 = convert.frame_from_numpy(r.f2, "cpu")
    m12, n = TM.match_for_initialization(f1, f2)
    np.testing.assert_array_equal(m12.numpy(), np.asarray(r.m12))
    m12L, nL = TM.match_lines_for_initialization(f1, f2)
    np.testing.assert_array_equal(m12L.numpy(), np.asarray(r.m12L))
    assert int(n) >= 70 and int(nL) >= 5


def _create_both(js, r, line_cap):
    """create_initial_map of both packages on fresh maps, same inputs."""
    s = js.settings
    N = r.N
    ok_p, ok_l = np.asarray(r.m12) >= 0, np.asarray(r.m12L) >= 0
    good, xyz = np.asarray(r.res.good), np.asarray(r.res.xyz)
    args = (r.m12, r.res.R21, r.res.t21, xyz[:N], good[:N] & ok_p, r.m12L,
            xyz[N:], good[N:] & ok_l)
    jmap = JMapState.empty(s.max_points, s.max_maplines, s.max_keyframes,
                           js.spec.total_capacity, line_cap)
    jst, jstep, jout = jax.device_get(JM.create_initial_map(
        jmap, r.f1, r.f2, *[jnp.asarray(a) for a in args],
        jnp.float32(r.i1 * 0.1), jnp.float32(r.i2 * 0.1), jnp.int32(r.i1),
        jnp.int32(r.i2), js.cam, scale_factor=s.scale_factor, n_levels=s.n_levels))
    tmap = TMap.MapState.empty(s.max_points, s.max_maplines, s.max_keyframes,
                               js.spec.total_capacity, line_cap, "cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    tcam = TS.Settings(**{k: getattr(s, k) for k in ("fx", "fy", "cx", "cy", "bf",
                                                     "width", "height")}).camera()
    tst, tstep, tout = TM.create_initial_map(
        tmap, convert.frame_from_numpy(r.f1, "cpu"), convert.frame_from_numpy(r.f2, "cpu"),
        *[t(a) for a in args], r.i1 * 0.1, r.i2 * 0.1, r.i1, r.i2, tcam,
        scale_factor=s.scale_factor, n_levels=s.n_levels)
    return (jst, jstep, np.asarray(jout)), (tst, tstep, tout.numpy())


def _assert_maps_match(jst, tst, pose_out):
    m = convert.map_state_to_numpy(tst)
    for grp, fields in (("pts", ("valid", "n_obs", "n_visible", "n_found", "first_kf", "desc")),
                        ("lns", ("valid", "n_obs", "first_kf", "desc")),
                        ("kfs", ("valid", "frame_id", "lm_idx", "ll_idx", "lvalid"))):
        for f in fields:
            np.testing.assert_array_equal(getattr(getattr(m, grp), f),
                                          np.asarray(getattr(getattr(jst, grp), f)),
                                          err_msg=f"{grp}.{f}")
    for f in ("n_pts", "n_lns", "n_kfs"):
        assert int(getattr(m, f)) == int(getattr(jst, f)), f
    v = np.asarray(jst.pts.valid)
    np.testing.assert_allclose(m.pts.xyz[v], np.asarray(jst.pts.xyz)[v], rtol=1e-3, atol=1e-3)
    # map-line points: off the reference's 3D line, not along it (a line
    # edge leaves its endpoints free to slide along the line)
    lv = np.asarray(jst.lns.valid)
    jx, tx = np.asarray(jst.lns.xyz)[lv], m.lns.xyz[lv]
    d = jx[:, 2] - jx[:, 0]
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    off = tx - jx
    off = off - np.sum(off * d[:, None], -1)[..., None] * d[:, None]
    np.testing.assert_allclose(off, 0, atol=1e-3)
    np.testing.assert_allclose(m.kfs.Tcw[:2], np.asarray(jst.kfs.Tcw)[:2], atol=1e-3)
    np.testing.assert_allclose(pose_out[1][3:], pose_out[0][3:], atol=1e-3)
    return v.sum(), lv.sum()


def test_create_initial_map_with_lines_matches_jax(runs, init_lines):
    js = runs[0]
    (jst, jstep, jout), (tst, tstep, tout) = _create_both(js, init_lines, 64)
    n_pts, n_lns = _assert_maps_match(jst, tst, (jout, tout))
    assert n_pts > 50 and n_lns >= 3
    np.testing.assert_array_equal(tstep.lm_gid.numpy(), np.asarray(jstep.lm_gid))
    np.testing.assert_array_equal(tstep.ll_gid.numpy(), np.asarray(jstep.ll_gid))
    np.testing.assert_allclose(tout[1], jout[1], rtol=1e-4)     # median depth


def test_create_initial_map_points_only_matches_jax(runs):
    js, _, frames, _ = runs
    r = _init_inputs(js, frames, with_lines=False)
    assert bool(r.res.ok)
    (jst, jstep, jout), (tst, tstep, tout) = _create_both(js, r, 1)
    n_pts, n_lns = _assert_maps_match(jst, tst, (jout, tout))
    assert n_pts > 50 and n_lns == 0
    np.testing.assert_array_equal(tstep.lm_gid.numpy(), np.asarray(jstep.lm_gid))


def test_vo_frame_step_mono_after_init_matches_jax(runs, init_lines):
    """One tracked frame on the map just built, in both packages."""
    from splslam_tpu.slam import pipeline as JP

    js, _, frames, _ = runs
    r = init_lines
    (jst, jstep, _), (tst, tstep, _) = _create_both(js, r, 64)
    img = np.asarray(frames[r.i2 + 1][0]).astype(np.uint8)
    s = js.settings
    jm, jnew, jstats = jax.device_get(JP.vo_frame_step_mono(
        jnp.asarray(img), jax.tree.map(jnp.asarray, jst), jax.tree.map(jnp.asarray, jstep),
        jnp.float32(1e9), jnp.int32(1), js.cam, js.spec, js.scales,
        m_local=s.local_window, scale_factor=s.scale_factor, n_levels=s.n_levels,
        with_lines=True, line_capacity=64))
    tcam = TS.Settings(fx=s.fx, fy=s.fy, cx=s.cx, cy=s.cy, width=320, height=240).camera()
    tm, tnew, tstats = TP.vo_frame_step_mono(
        torch.from_numpy(img), tst, tstep, 1e9, 1, tcam, js.spec,
        torch.tensor(js.spec.scales, dtype=torch.float32), m_local=s.local_window,
        scale_factor=s.scale_factor, n_levels=s.n_levels, with_lines=True,
        line_capacity=64)
    jv, tv = np.asarray(jstats), tstats.numpy()
    np.testing.assert_array_equal(tv[16:], jv[16:])     # counts
    np.testing.assert_allclose(tv[:16], jv[:16], atol=1e-4)
    np.testing.assert_array_equal(tnew.lm_gid.numpy(), np.asarray(jnew.lm_gid))
    np.testing.assert_array_equal(tnew.ll_gid.numpy(), np.asarray(jnew.ll_gid))
    assert tv[TP.S_N_LN_IN] >= 1 and tv[TP.S_N_IN] > 30
    mm = convert.map_state_to_numpy(tm)
    for f in ("n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(mm.pts, f), np.asarray(getattr(jm.pts, f)))
        np.testing.assert_array_equal(getattr(mm.lns, f), np.asarray(getattr(jm.lns, f)))
    np.testing.assert_allclose(mm.lns.avg_len2d, np.asarray(jm.lns.avg_len2d), atol=1e-3)


def test_track_mono_system_matches_jax(runs):
    js, ts, _, gt = runs
    assert ts.get_tracking_state() == TS.TrackingState.OK
    assert js.get_tracking_state() == JS.TrackingState.OK
    # the same bootstrap: init frame, model, keyframes
    assert [e.ts for e in ts.trajectory[:2]] == [e.ts for e in js.trajectory[:2]]
    assert ts.init_used_h is js.init_used_h
    assert ts.n_kfs == js.n_kfs >= 3
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert int(ts.map.lns.valid.sum()) == int(np.asarray(js.map.lns.valid).sum()) >= 3
    pt, pj = ts.poses(), js.poses()
    assert pt.shape == pj.shape
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=POSE_ATOL)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=POSE_ATOL)
    idx = [int(round(e.ts / 0.1)) for e in ts.trajectory if not e.lost]
    assert ate_rmse(pt, gt[idx], align_scale=True) < 0.15


def test_line_inliers_per_frame_match_jax(runs):
    """Every tracked frame's line inliers equal the reference's: where the
    port matches no map line, the reference matches none either."""
    js, ts, _, _ = runs
    assert ts.ln_in == js.ln_in
    assert len(ts.ln_in) >= 10 and max(ts.ln_in) >= 1


def test_track_mono_trajectory_export(runs, tmp_path):
    js, ts, _, _ = runs
    p = tmp_path / "mono.kitti"
    ts.save_trajectory_kitti_mono(str(p))
    rows = np.loadtxt(p)
    assert rows.shape == (len(ts.trajectory), 12)
    js.save_trajectory_kitti_mono(str(tmp_path / "j.kitti"))
    np.testing.assert_allclose(rows, np.loadtxt(tmp_path / "j.kitti"), atol=POSE_ATOL)


def test_mono_points_with_local_mapping():
    """tests/test_e2e_mono.py's run_mono (points only, local mapping,
    relocalization and loop detection on: the JAX defaults), cut to 20
    frames: OK, keyframes, mapping steps, ATE < 0.1, no BA revert."""
    K, _, frames, gt = make_stereo_sequence(n_frames=20, motion="lateral",
                                            width=320, height=240)
    sysm = TS.System(TS.Settings(**settings_kw(K)), TS.Sensor.MONOCULAR, "cpu")
    assert sysm.vocab is not None and sysm.settings.enable_local_mapping
    for i, (l, _) in enumerate(frames):
        sysm.track_mono(l, i * 0.1)
    sysm.drain()
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    assert sysm.n_kfs >= 3 and sysm.mapper.n_steps >= 1
    h = sysm.health()
    assert h["mapping_state_revert"] == 0
    idx = [int(round(e.ts / 0.1)) for e in sysm.trajectory if not e.lost]
    assert ate_rmse(sysm.poses(), gt[idx], align_scale=True) < 0.1
    assert int(sysm.map.pts.valid.sum()) > 50
