"""Tracking, local window and keyframe insertion of the PyTorch port
against the JAX reference, on identical state: a JAX System tracks a few
frames of the forward sequence (keyframes forced every 2 frames so the
map holds several), its map, tracker state and next frame are pulled to
numpy, and `splslam_tpu_torch.convert` hands the same state to the port.

Tolerances: landmark ids, inlier masks, counts and window ids exact;
poses within 1e-4 (float32 sums in another order, and XLA's fused
multiply-adds); landmark positions within 1e-5."""

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
    """The port counts every shared landmark. The reference drops landmark
    0: its scatter-set writes True (landmark 0) and False (each -1,
    clipped to 0) into slot 0, and XLA's CPU scatter keeps the last write
    (ROADMAP queue C). Everything else must agree exactly."""
    from splslam_tpu.slam import map as JM

    q = np.array(ref.step.lm_gid)
    got = TMap.covisibility_counts(fresh_map(ref), torch.from_numpy(q)).numpy()
    kf_lm = np.asarray(ref.map.kfs.lm_idx)
    member = np.zeros(ref.map.pts.xyz.shape[0], bool)
    member[q[q >= 0]] = True
    expect = ((kf_lm >= 0) & member[np.clip(kf_lm, 0, None)]).sum(1) \
        * np.asarray(ref.map.kfs.valid)
    np.testing.assert_array_equal(got, expect)
    jax_counts = np.asarray(JM.covisibility_counts(ref.map, ref.step.lm_gid))
    dropped = (kf_lm == 0).any(1) & member[0] & np.asarray(ref.map.kfs.valid)
    np.testing.assert_array_equal(got - jax_counts, dropped.astype(int))


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
        n_levels=4)
    jstats = np.asarray(jstats)
    np.testing.assert_array_equal(tstats.numpy()[16:], jstats[16:])
    np.testing.assert_allclose(tstats.numpy()[:16], jstats[:16], atol=1e-4)
    np.testing.assert_array_equal(tst.lm_gid.numpy(), np.asarray(js.lm_gid))
    for f in ("n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(tm.pts, f).numpy(),
                                      np.asarray(getattr(jm.pts, f)), err_msg=f)


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
