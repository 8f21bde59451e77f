"""Tracking, local window and keyframe insertion of the PyTorch port
against the JAX reference, on identical state: a JAX System tracks a few
frames of the forward sequence (keyframes forced every 2 frames so the
map holds several), its map, tracker state and next frame are pulled to
numpy, and `splslam_tpu_torch.convert` hands the same state to the port.

The line branch: `line_projection_match` on synthetic map lines (the
motion-model and local-window settings), and `assemble_line_window` and
`track_step` with lines on a monocular map the reference initialized
from frames 0 and 1 of the grid sequence (its `create_initial_map`),
tracking frame 2.

Localization mode: the temporal points of `_track_body` and the whole
stereo step with `loc_mode` on the same state.

Tolerances: landmark and map-line ids, inlier masks, counts and window
ids exact; poses within 1e-4 (float32 sums in another order, and XLA's
fused multiply-adds); landmark positions within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.slam import frame as JF
from splslam_tpu.slam import pipeline as JP
from splslam_tpu.slam import system as JS
from splslam_tpu.slam import tracking as JT
from splslam_tpu_torch import convert
from splslam_tpu_torch.geometry.camera import Camera as TCam
from splslam_tpu_torch.slam import map as TMap
from splslam_tpu_torch.slam import pipeline as TP
from splslam_tpu_torch.slam import tracking as TT

W, H, M_LOCAL = 320, 240, 1024
N_PRE = 7  # frames tracked by the reference before the compared step


class Ref:
    """Reference state after N_PRE frames, as numpy NamedTuples."""


@pytest.fixture(scope="module")
def ref():
    K, bf, frames, _ = make_stereo_sequence(n_frames=N_PRE + 1, motion="forward",
                                            width=W, height=H)
    st = JS.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
        cy=float(K[1, 2]), bf=float(bf), width=W, height=H, n_features=600,
        n_levels=4, th_depth=40.0, fps=10, max_points=8192, max_keyframes=64,
        local_window=M_LOCAL, enable_local_mapping=False,
        enable_relocalization=False, force_kf_every=2,
    )
    js = JS.System(st, JS.Sensor.STEREO)
    for i, (l, r) in enumerate(frames[:N_PRE]):
        js.track_stereo(l, r, i * 0.1)
    js.drain()
    assert js.n_kfs >= 3
    r = Ref()
    r.sys = js
    r.imgs = np.stack(frames[N_PRE]).astype(np.uint8)
    r.jcam = js.cam
    r.tcam = TCam.create(st.fx, st.fy, st.cx, st.cy, bf=st.bf, width=W, height=H)
    r.spec = js.spec
    r.map = jax.device_get(js.map)
    r.step = jax.device_get(js.step)
    r.frame = jax.device_get(JF.build_frame_stereo(
        jnp.asarray(r.imgs[0], jnp.float32), jnp.asarray(r.imgs[1], jnp.float32),
        js.cam, js.spec, line_capacity=1))
    r.scales = np.asarray(js.spec.scales, np.float32)
    return r


def fresh_map(r):
    return convert.map_state_from_numpy(r.map, "cpu")


def test_convert_round_trip(ref):
    m = convert.map_state_to_numpy(fresh_map(ref))
    for group in ("pts", "lns", "kfs"):
        a, b = getattr(m, group), getattr(ref.map, group)
        for f in b._fields:
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)),
                                          err_msg=f"{group}.{f}")
            assert getattr(a, f).dtype == np.asarray(getattr(b, f)).dtype
    s = convert.step_state_to_numpy(convert.step_state_from_numpy(ref.step, "cpu"))
    np.testing.assert_array_equal(s.frame.feat.desc, ref.step.frame.feat.desc)
    np.testing.assert_array_equal(s.lm_gid, ref.step.lm_gid)


def test_assemble_local_window(ref):
    jw = jax.device_get(JP.assemble_local_window(ref.map, ref.step.lm_gid, M_LOCAL))
    tw = convert.local_window_to_numpy(TP.assemble_local_window(
        fresh_map(ref), torch.from_numpy(np.array(ref.step.lm_gid)), M_LOCAL))
    for f in jw._fields:
        np.testing.assert_array_equal(getattr(tw, f), np.asarray(getattr(jw, f)),
                                      err_msg=f)
    assert (np.asarray(jw.ids) >= 0).sum() > 100


def test_covisibility_counts(ref):
    """Equal to the reference, landmark 0 included: the reference's
    scatter-set writes True (landmark 0) and False (each -1, clipped to
    0) into slot 0 and XLA's CPU scatter keeps the last write; the port
    reproduces that rule (`map.landmark_membership`)."""
    from splslam_tpu.slam import map as JM

    q = np.array(ref.step.lm_gid)
    got = TMap.covisibility_counts(fresh_map(ref), torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JM.covisibility_counts(ref.map, ref.step.lm_gid)))
    assert got.max() > 100


@pytest.mark.parametrize("row,member0", [
    ([5, 0, 7, -1, -1, 3], False),   # landmark 0, then a -1
    ([-1, 5, -1, 0, 7, 3], True),    # landmark 0 is the last entry <= 0
    ([4, 2, 9], False),              # nothing clips onto slot 0
])
def test_covisibility_counts_landmark_zero(ref, row, member0):
    """Hand-built query rows that pin both branches of the rule."""
    from splslam_tpu.slam import map as JM

    m = jax.device_get(ref.map)
    lm = np.array(m.kfs.lm_idx)
    lm[:2] = -1
    lm[0, :6] = [0, 2, 3, 4, 5, 9]
    lm[1, :3] = [0, 7, -1]
    m = m._replace(kfs=m.kfs._replace(lm_idx=lm))
    q = np.asarray(row, np.int32)
    jc = np.asarray(JM.covisibility_counts(jax.tree.map(jnp.asarray, m), jnp.asarray(q)))
    tc = TMap.covisibility_counts(convert.map_state_from_numpy(m, "cpu"),
                                  torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert TMap.landmark_membership(torch.from_numpy(q), 16)[0].item() == member0
    assert jc[1] == int(member0) + (7 in row)


def _jax_window(r):
    return JP.assemble_local_window(r.map, r.step.lm_gid, M_LOCAL)


def test_track_step(ref):
    s = ref.step
    T_pred = np.array(jnp.asarray(s.velocity) @ jnp.asarray(s.Tcw))
    jwin = _jax_window(ref)
    jr = JT.track_step(
        ref.jcam, jnp.asarray(ref.scales), ref.frame,
        s.frame.feat.xy, s.frame.feat.octave, s.frame.feat.angle,
        s.frame.feat.bits, s.lm_xyz, s.lm_gid, jnp.asarray(T_pred), jwin,
        s.frame.lines, s.ll_gid, s.ll_xyz3, s.ll_len, JT.LineWindow.empty(1),
        scale_factor=1.2, n_levels=4,
    )
    ts = convert.step_state_from_numpy(s, "cpu")
    tf = convert.frame_from_numpy(ref.frame, "cpu")
    tr = TT.track_step(
        ref.tcam, torch.from_numpy(ref.scales), tf, ts.frame.feat.octave,
        ts.frame.feat.angle, ts.frame.feat.desc, ts.lm_xyz, ts.lm_gid,
        torch.from_numpy(T_pred),
        convert.local_window_from_numpy(jax.device_get(jwin), "cpu"),
        scale_factor=1.2, n_levels=4,
    )
    for f in ("lm_gid", "inlier", "n_mm_matches", "n_inliers", "visible_ids",
              "found_ids", "ll_gid", "ln_inlier", "n_ln_inliers"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    np.testing.assert_allclose(tr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-4)
    assert int(jr.n_inliers) > 100


def test_bow_free_refkf_match(ref):
    k = ref.sys.ref_kf
    kfs = ref.map.kfs
    lm = np.asarray(kfs.lm_idx[k])
    xyz = np.asarray(ref.map.pts.xyz)[np.clip(lm, 0, None)]
    T0 = np.array(ref.step.Tcw)
    jr = JT.bow_free_refkf_match(ref.jcam, ref.frame, kfs.desc[k], kfs.angle[k],
                                 kfs.fvalid[k], lm, xyz, jnp.asarray(T0))
    tk = fresh_map(ref).kfs
    tr = TT.bow_free_refkf_match(
        ref.tcam, convert.frame_from_numpy(ref.frame, "cpu"), tk.desc[k],
        tk.angle[k], tk.fvalid[k], tk.lm_idx[k], torch.from_numpy(xyz),
        torch.from_numpy(T0))
    for f in ("lm_gid", "inlier", "n_mm_matches", "n_inliers"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    np.testing.assert_allclose(tr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-4)
    assert int(jr.n_inliers) > 50


def test_vo_frame_step(ref):
    """The whole per-frame step: frame build, window, tracking, stats and
    the in-place landmark counter update."""
    args = (ref.sys.th_depth_m, ref.sys.ref_kf)
    jm, js, jstats = JP.vo_frame_step(
        jnp.asarray(ref.imgs), jax.tree.map(jnp.array, ref.map), ref.step,
        jnp.float32(args[0]), jnp.int32(args[1]), ref.jcam, ref.spec,
        jnp.asarray(ref.scales), m_local=M_LOCAL, scale_factor=1.2, n_levels=4,
        line_capacity=1)
    tm, tst, tstats = TP.vo_frame_step(
        torch.from_numpy(ref.imgs), fresh_map(ref),
        convert.step_state_from_numpy(ref.step, "cpu"), args[0], args[1],
        ref.tcam, TP.PyramidSpec.create(H, W, 4, 1.2, 600),
        torch.from_numpy(ref.scales), m_local=M_LOCAL, scale_factor=1.2,
        n_levels=4, line_capacity=1)
    jstats = np.asarray(jstats)
    np.testing.assert_array_equal(tstats.numpy()[16:], jstats[16:])
    np.testing.assert_allclose(tstats.numpy()[:16], jstats[:16], atol=1e-4)
    np.testing.assert_array_equal(tst.lm_gid.numpy(), np.asarray(js.lm_gid))
    for f in ("n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(tm.pts, f).numpy(),
                                      np.asarray(getattr(jm.pts, f)), err_msg=f)


def test_track_body_localization_mode(ref, monkeypatch):
    """Localization mode on identical state: the temporal points (gid -2,
    the previous frame's untracked depth features unprojected to world)
    that `_track_body` hands the tracking step, and its outputs. The
    reference's `_track_body` runs eagerly here, recording the arguments
    of its (jitted) tracking step."""
    seen = {}
    track = JP.track_step

    def record(*args, **kw):
        seen["xyz"], seen["gid"] = np.asarray(args[7]), np.asarray(args[8])
        return track(*args, **kw)

    monkeypatch.setattr(JP, "track_step", record)
    args = (ref.sys.th_depth_m, ref.sys.ref_kf)
    _, js, jstats = JP._track_body(
        ref.frame, jax.tree.map(jnp.array, ref.map), ref.step, jnp.float32(args[0]),
        jnp.int32(args[1]), ref.jcam, jnp.asarray(ref.scales), M_LOCAL, 1.2, 4,
        loc_mode=True)[:3]
    jstats = jstats[0]
    prev = convert.step_state_from_numpy(ref.step, "cpu")
    gid, xyz = TP._temporal_points(prev, ref.tcam)
    gid, xyz = gid.numpy(), xyz.numpy()
    n_tmp = int((seen["gid"] == -2).sum())
    assert n_tmp == int((gid == -2).sum()) > 50
    np.testing.assert_array_equal(gid, seen["gid"])
    np.testing.assert_allclose(xyz, seen["xyz"], atol=1e-5)
    _, ts, tstats, _, _ = TP._track_body(
        convert.frame_from_numpy(ref.frame, "cpu"), fresh_map(ref), prev, args[0],
        args[1], ref.tcam, torch.from_numpy(ref.scales), M_LOCAL, 1.2, 4,
        loc_mode=True)
    jstats = np.asarray(jstats)
    np.testing.assert_array_equal(tstats.numpy()[16:], jstats[16:])
    np.testing.assert_allclose(tstats.numpy()[:16], jstats[:16], atol=1e-4)
    np.testing.assert_array_equal(ts.lm_gid.numpy(), np.asarray(js.lm_gid))
    assert ts.lm_gid.min() >= -1


def test_vo_frame_step_localization_mode(ref):
    """The whole stereo step with `loc_mode` against the reference's jitted
    step: the counts (the motion-model matches include temporal points)
    and landmark ids exact, no -2 in the new associations, pose within
    1e-4. With `loc_mode=False` the step is the default step, bit for bit."""
    args = (ref.sys.th_depth_m, ref.sys.ref_kf)
    _, js, jstats = JP.vo_frame_step(
        jnp.asarray(ref.imgs), jax.tree.map(jnp.array, ref.map), ref.step,
        jnp.float32(args[0]), jnp.int32(args[1]), ref.jcam, ref.spec,
        jnp.asarray(ref.scales), m_local=M_LOCAL, scale_factor=1.2, n_levels=4,
        line_capacity=1, loc_mode=jnp.bool_(True))
    spec = TP.PyramidSpec.create(H, W, 4, 1.2, 600)

    def port_step(**kw):
        return TP.vo_frame_step(
            torch.from_numpy(ref.imgs), fresh_map(ref),
            convert.step_state_from_numpy(ref.step, "cpu"), args[0], args[1],
            ref.tcam, spec, torch.from_numpy(ref.scales), m_local=M_LOCAL,
            scale_factor=1.2, n_levels=4, line_capacity=1, **kw)

    _, ts, tstats = port_step(loc_mode=True)
    jstats = np.asarray(jstats)
    np.testing.assert_array_equal(tstats.numpy()[16:], jstats[16:])
    np.testing.assert_allclose(tstats.numpy()[:16], jstats[:16], atol=1e-4)
    np.testing.assert_array_equal(ts.lm_gid.numpy(), np.asarray(js.lm_gid))
    assert ts.lm_gid.min() >= -1
    m_off, s_off, st_off = port_step(loc_mode=False)
    m_def, s_def, st_def = port_step()
    assert torch.equal(st_off, st_def) and torch.equal(s_off.lm_gid, s_def.lm_gid)
    assert torch.equal(s_off.Tcw, s_def.Tcw)
    assert torch.equal(m_off.pts.n_visible, m_def.pts.n_visible)
    assert st_off[TP.S_N_MM] < tstats[TP.S_N_MM]


@pytest.mark.parametrize("max_new,depth_limit", [(200, None), (1000, 1e9)])
def test_add_keyframe_step(ref, max_new, depth_limit):
    """insert_keyframe + create_stereo_points on identical state."""
    limit = ref.sys.th_depth_m if depth_limit is None else depth_limit
    fid, ts = 11, 0.7
    jm, js, jout = JP.add_keyframe_step(
        jax.tree.map(jnp.array, ref.map), ref.step, jnp.int32(fid),
        jnp.float32(ts), jnp.float32(limit), ref.jcam, ref.spec,
        scale_factor=1.2, n_levels=4, max_new=max_new)
    tm, tst, tout = TP.add_keyframe_step(
        fresh_map(ref), convert.step_state_from_numpy(ref.step, "cpu"), fid, ts,
        limit, ref.tcam, scale_factor=1.2, n_levels=4, max_new=max_new)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tst.lm_gid.numpy(), np.asarray(js.lm_gid))
    jm = jax.device_get(jm)
    tm = convert.map_state_to_numpy(tm)
    for f in ("n_pts", "n_kfs"):
        assert int(getattr(tm, f)) == int(getattr(jm, f))
    exact = {"pts": ("desc", "n_obs", "n_visible", "n_found", "first_kf", "valid"),
             "kfs": ("Tcw", "xy", "octave", "desc", "fvalid", "lm_idx", "valid",
                     "frame_id", "ts", "u_right", "depth")}
    for group, fields in exact.items():
        for f in fields:
            np.testing.assert_array_equal(getattr(getattr(tm, group), f),
                                          getattr(getattr(jm, group), f),
                                          err_msg=f"{group}.{f}")
    for f in ("xyz", "normal"):
        np.testing.assert_allclose(getattr(tm.pts, f), getattr(jm.pts, f),
                                   atol=1e-5, err_msg=f)
    for f in ("dmin", "dmax"):
        np.testing.assert_allclose(getattr(tm.pts, f), getattr(jm.pts, f),
                                   rtol=1e-5, err_msg=f)
    assert int(jm.n_kfs) == int(ref.map.n_kfs) + 1
    if depth_limit is not None:   # every unmatched stereo point qualifies
        assert int(jm.n_pts) > int(ref.map.n_pts)


# ---------------------------------------------------------------------
# lines
# ---------------------------------------------------------------------
def _line_match_inputs(seed):
    """Q synthetic 3D lines, their projections as the current frame's line
    features (noisy, some dropped, shuffled), random LBD words with a few
    flipped bits per true pair."""
    from splslam_tpu.ops.lines import LineFeatures as JLF

    r = np.random.default_rng(seed)
    Q, Lc = 48, 40
    A = np.stack([r.uniform(-2, 2, Q), r.uniform(-1.5, 1.5, Q), r.uniform(3, 8, Q)], 1)
    B = A + r.normal(0, 0.5, (Q, 3))
    xyz3 = np.stack([A, 0.5 * (A + B), B], 1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.1]
    f, c = 200.0, np.array([160.0, 120.0])
    proj = lambda P: f * (P @ T[:3, :3].T + T[:3, 3])[:, :2] / (P @ T[:3, :3].T + T[:3, 3])[:, 2:] + c
    seg = np.concatenate([proj(A), proj(B)], 1) + r.normal(0, 0.5, (Q, 4))
    perm = r.permutation(Q)[:Lc]
    seg = seg[perm].astype(np.float32)
    words = r.integers(0, 2 ** 32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    flip = np.zeros((Q, 256), np.uint8)
    flip[:, r.choice(256, 6, replace=False)] = 1
    cur_words = words[perm] ^ np.packbits(flip[perm], axis=1, bitorder="little").view(np.uint32)
    d = seg[:, 2:] - seg[:, :2]
    cur = JLF(seg=seg, midpoint=0.5 * (seg[:, :2] + seg[:, 2:]),
              angle=np.arctan2(d[:, 1], d[:, 0]).astype(np.float32),
              length=np.linalg.norm(d, axis=1).astype(np.float32),
              response=np.ones(Lc, np.float32), desc=cur_words,
              valid=r.random(Lc) > 0.1, octave=np.zeros(Lc, np.int32))
    avg_len = np.linalg.norm(proj(A) - proj(B), axis=1).astype(np.float32)
    row_ok = r.random(Q) > 0.1
    already = r.random(Lc) > 0.8
    return T, cur, xyz3, words, avg_len, row_ok, already, perm


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, {}), (2, dict(perp_r=6.0))])
def test_line_projection_match(seed, kw):
    from splslam_tpu.geometry.camera import Camera as JCam
    from splslam_tpu_torch.ops.lines import LineFeatures as TLF

    T, cur, xyz3, words, avg_len, row_ok, already, perm = _line_match_inputs(seed)
    cam_kw = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240)
    jm, jd = JT.line_projection_match(JCam.create(**cam_kw), jnp.asarray(T),
                                      jax.tree.map(jnp.asarray, cur), jnp.asarray(xyz3),
                                      jnp.asarray(words), jnp.asarray(avg_len),
                                      jnp.asarray(row_ok), jnp.asarray(already), **kw)
    t = lambda a: torch.from_numpy(np.array(a))
    tm, td = TT.line_projection_match(
        TCam.create(**cam_kw), t(T), TLF(*[t(np.asarray(x).view(np.int32)
                                           if np.asarray(x).dtype == np.uint32 else x)
                                         for x in cur]),
        t(xyz3), t(words.view(np.int32)), t(avg_len), t(row_ok), t(already), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    m = tm.numpy()
    assert (m >= 0).sum() >= 15
    hit = m >= 0
    # true pairs: current feature j is map line perm[j]
    assert (perm[m[hit]] == np.nonzero(hit)[0]).mean() > 0.9


class LineRef:
    """A reference monocular map with map lines, and frame 2 to track."""


@pytest.fixture(scope="module")
def line_ref():
    from splslam_tpu.slam import mono as JM
    from splslam_tpu.slam.initializer import two_view_init
    from splslam_tpu.slam.map import MapState as JMapState

    K, _, frames, _ = make_stereo_sequence(n_frames=3, motion="lateral", width=W,
                                           height=H, texture="grid")
    st = JS.Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), width=W, height=H, n_features=600,
                     n_levels=4, max_points=8192, max_keyframes=64,
                     local_window=M_LOCAL)
    cam, spec = st.camera(), JS.PyramidSpec.create(H, W, 4, 1.2, 600)
    build = lambda i: JF.build_frame_mono(jnp.asarray(frames[i][0], jnp.float32), cam,
                                          spec, with_lines=True, line_capacity=64)
    f1, f2, f3 = build(0), build(1), build(2)
    m12, _ = JM.match_for_initialization(f1, f2)
    m12L, _ = JM.match_lines_for_initialization(f1, f2)
    N = f1.feat.capacity
    ok = jnp.concatenate([m12 >= 0, m12L >= 0])
    res = two_view_init(
        jax.random.PRNGKey(0), jnp.concatenate([f1.feat.xy, f1.lines.midpoint]),
        jnp.concatenate([f2.feat.xy[jnp.clip(m12, 0)],
                         f2.lines.midpoint[jnp.clip(m12L, 0)]]), ok, cam.K,
        inv_sigma2=jnp.concatenate([jnp.ones((N,)), jnp.full((64,), 1.0 / 9.0)]))
    assert bool(res.ok)
    mp, step, _ = JM.create_initial_map(
        JMapState.empty(8192, 4096, 64, spec.total_capacity, 64), f1, f2, m12,
        res.R21, res.t21, res.xyz[:N], res.good[:N] & (m12 >= 0), m12L, res.xyz[N:],
        res.good[N:] & (m12L >= 0), jnp.float32(0.0), jnp.float32(0.1),
        jnp.int32(0), jnp.int32(1), cam, scale_factor=1.2, n_levels=4)
    r = LineRef()
    r.map, r.step, r.frame = jax.device_get((mp, step, f3))
    r.jcam = cam
    r.tcam = TCam.create(st.fx, st.fy, st.cx, st.cy, width=W, height=H)
    r.scales = np.asarray(spec.scales, np.float32)
    assert (np.asarray(r.step.ll_gid) >= 0).sum() >= 3
    return r


def test_assemble_line_window(line_ref):
    r = line_ref
    jw = jax.device_get(JP.assemble_line_window(r.map, r.step.ll_gid, r.step.lm_gid, 256))
    tw = convert.line_window_to_numpy(TP.assemble_line_window(
        convert.map_state_from_numpy(r.map, "cpu"),
        torch.from_numpy(np.array(r.step.ll_gid)),
        torch.from_numpy(np.array(r.step.lm_gid)), 256))
    for f in jw._fields:
        np.testing.assert_array_equal(getattr(tw, f), np.asarray(getattr(jw, f)), err_msg=f)
    assert (np.asarray(jw.ids) >= 0).sum() >= 3


def test_track_step_with_lines(line_ref):
    r = line_ref
    s = r.step
    T_pred = np.array(jnp.asarray(s.velocity) @ jnp.asarray(s.Tcw))
    jwin = JP.assemble_local_window(r.map, s.lm_gid, M_LOCAL)
    jlwin = JP.assemble_line_window(r.map, s.ll_gid, s.lm_gid, 256)
    jr = JT.track_step(
        r.jcam, jnp.asarray(r.scales), r.frame, s.frame.feat.xy, s.frame.feat.octave,
        s.frame.feat.angle, s.frame.feat.bits, s.lm_xyz, s.lm_gid, jnp.asarray(T_pred),
        jwin, s.frame.lines, s.ll_gid, s.ll_xyz3, s.ll_len, jlwin,
        scale_factor=1.2, n_levels=4)
    ts = convert.step_state_from_numpy(s, "cpu")
    tr = TT.track_step(
        r.tcam, torch.from_numpy(r.scales), convert.frame_from_numpy(r.frame, "cpu"),
        ts.frame.feat.octave, ts.frame.feat.angle, ts.frame.feat.desc, ts.lm_xyz,
        ts.lm_gid, torch.from_numpy(T_pred),
        convert.local_window_from_numpy(jax.device_get(jwin), "cpu"),
        last_lines=ts.frame.lines, last_ll_gid=ts.ll_gid, last_ll_xyz3=ts.ll_xyz3,
        last_ll_len=ts.ll_len,
        lwin=convert.line_window_from_numpy(jax.device_get(jlwin), "cpu"),
        scale_factor=1.2, n_levels=4)
    for f in ("lm_gid", "inlier", "n_mm_matches", "n_inliers", "visible_ids",
              "found_ids", "ll_gid", "ln_inlier", "n_ln_inliers"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    np.testing.assert_allclose(tr.Tcw.numpy(), np.asarray(jr.Tcw), atol=1e-4)
    assert int(jr.n_inliers) > 30 and int(jr.n_ln_inliers) >= 1


def test_update_point_and_line_stats(line_ref):
    """The counters add over repeated ids; the line length average is a
    scatter-set at clip(id, 0) whose last row wins (`-1` rows write slot 0
    its own value back), as the reference's XLA scatter."""
    from splslam_tpu.slam import map as JMap

    r = line_ref
    rng = np.random.default_rng(9)
    n_l = int(r.map.n_lns)
    ids = rng.integers(-1, max(n_l, 2), 48).astype(np.int32)
    ids[:4] = [0, -1, 0, 1]
    vis = rng.integers(-1, max(n_l, 2), 64).astype(np.int32)
    flen = rng.uniform(10, 90, 48).astype(np.float32)
    pidx = rng.integers(-1, 200, 300).astype(np.int32)
    pv, pf = rng.random(300) > 0.3, rng.random(300) > 0.5
    jm = jax.device_get(JMap.update_line_stats(r.map, vis, ids, flen))
    jm = jax.device_get(JMap.update_point_stats(jm, pidx, pv, pf))
    tm = TMap.update_line_stats(fresh_map(r), torch.from_numpy(vis),
                                torch.from_numpy(ids), torch.from_numpy(flen))
    tm = convert.map_state_to_numpy(TMap.update_point_stats(
        tm, torch.from_numpy(pidx), torch.from_numpy(pv), torch.from_numpy(pf)))
    for grp, f in (("lns", "n_visible"), ("lns", "n_found"), ("lns", "avg_len2d"),
                   ("pts", "n_visible"), ("pts", "n_found")):
        np.testing.assert_array_equal(getattr(getattr(tm, grp), f),
                                      np.asarray(getattr(getattr(jm, grp), f)),
                                      err_msg=f"{grp}.{f}")
