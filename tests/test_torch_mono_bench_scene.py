"""Monocular point+line tracking on bench_mono.py's scene (the sequence of
chip_smoke.py's phases 9 and 10), the port against the JAX package on
the CPU: 640x480, fx 520, the grid texture, oscillating motion
(amplitude 0.5, seed 4), 1000 features, 8 levels, 128 line slots, local
mapping, relocalization and loop closing off (bench_mono.py:55-92), cut
to N_FRAMES frames. Both runs see the reference's two-view RANSAC
hypotheses, as in tests/test_torch_mono.py.

Gates: the same init frames and keyframes, the same map lines, and the
same median line inliers a frame. The two free runs drift apart by float
noise: their poses are ~1e-4 apart after 28 frames, and the jitted
reference's line detector puts a frame-37 line at another octave (and
its endpoints up to 1.7 px away) where its own op-by-op run and the port
agree (ROADMAP queue C); from then on a borderline line match can go one
way in one run and the other way in the other. So the frame-by-frame
gate is taken in lockstep: before each frame a third port System takes
over the reference's map and tracker state, builds the frame and tracks
it; the reference's `track_step` then runs on that call's own inputs
and must give the same point and line associations and line-inlier
count, and a pose within LOCKSTEP_POSE_ATOL."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.ops.lines import LineFeatures as JLines
from splslam_tpu.ops.match import unpack_bits
from splslam_tpu.ops.orb import OrbFeatures as JOrb
from splslam_tpu.slam import system as JS
from splslam_tpu.slam import tracking as JT
from splslam_tpu.slam.frame import FrameData as JFrame
from splslam_tpu_torch import convert
from splslam_tpu_torch.slam import mono as TM
from splslam_tpu_torch.slam import pipeline as TP
from splslam_tpu_torch.slam import system as TS
from test_torch_mono import jax_samples, record_line_inliers

N_FRAMES = 40
W, H, FPS = 640, 480, 30.0
LOCKSTEP_POSE_ATOL = 1e-5


def settings(S, K):
    return S.Settings(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        bf=0.0, width=W, height=H, n_features=1000, n_levels=8, fps=FPS,
        max_points=16384, max_keyframes=128, local_window=2048, using_line=True,
        line_features=128, min_kf_gap=20, enable_local_mapping=False,
        enable_relocalization=False, enable_loop_closing=False)


def _bits(desc):
    """The reference's cached +-1 bit planes of packed descriptors."""
    return unpack_bits(jnp.asarray(desc)).astype(jnp.bfloat16) * 2.0 - 1.0


def _jax_frame(frame):
    f = convert.frame_to_numpy(frame)
    feat = JOrb(**{k: jnp.asarray(getattr(f.feat, k)) for k in f.feat._fields},
                bits=_bits(f.feat.desc))
    return JFrame(feat=feat, u_right=jnp.asarray(f.u_right), depth=jnp.asarray(f.depth),
                  lines=JLines(*[jnp.asarray(x) for x in f.lines]))


def jax_track_step(jcam, prev, args, kw):
    """The reference's `track_step` on the inputs of one port call."""
    _, scales, cur, last_oct, last_angle, _, last_xyz, last_gid, T_pred, win = args
    n = lambda t: jnp.asarray(t.numpy())
    last = convert.frame_to_numpy(prev.frame)
    return jax.device_get(JT.track_step(
        jcam, n(scales), _jax_frame(cur), jnp.asarray(last.feat.xy), n(last_oct),
        n(last_angle), _bits(last.feat.desc), n(last_xyz), n(last_gid), n(T_pred),
        jax.tree.map(jnp.asarray, convert.local_window_to_numpy(win)),
        JLines(*[jnp.asarray(x) for x in convert.line_features_to_numpy(kw["last_lines"])]),
        n(kw["last_ll_gid"]), n(kw["last_ll_xyz3"]), n(kw["last_ll_len"]),
        jax.tree.map(jnp.asarray, convert.line_window_to_numpy(kw["lwin"])),
        scale_factor=kw["scale_factor"], n_levels=kw["n_levels"]))


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    K, _, frames, _ = make_stereo_sequence(
        n_frames=N_FRAMES, width=W, height=H, fx=520.0, motion="oscillate", seed=4,
        osc_amp=0.5, texture="grid")
    js = JS.System(settings(JS, K), JS.Sensor.MONOCULAR)
    ts = TS.System(settings(TS, K), TS.Sensor.MONOCULAR, "cpu")
    lock = TS.System(settings(TS, K), TS.Sensor.MONOCULAR, "cpu")
    steps, calls = [], []
    run_track = TP.track_step

    def recorded(*args, **kw):
        out = run_track(*args, **kw)
        calls.append((args, kw, out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(TM, "draw_init_samples", jax_samples)
    try:
        for sysm in (js, ts, lock):
            record_line_inliers(sysm)
        for i, (l, _) in enumerate(frames):
            take_over = js.step is not None and lock.step is not None
            if take_over:
                jmap, jstep = jax.device_get((js.map, js.step))
            for sysm in (js, ts):
                sysm.track_mono(l, i / FPS)
                sysm.drain()
            if not take_over:
                lock.track_mono(l, i / FPS)
                lock.drain()
                continue
            lock.map = convert.map_state_from_numpy(jmap, "cpu")
            lock.step = prev = convert.step_state_from_numpy(jstep, "cpu")
            calls.clear()
            mp.setattr(TP, "track_step", recorded)
            lock.track_mono(l, i / FPS)
            lock.drain()
            mp.setattr(TP, "track_step", run_track)
            (args, kw, out), = calls
            steps.append((i, prev, args, kw, out, js.n_kfs, lock.n_kfs))
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return js, ts, lock, steps


def test_same_bootstrap_keyframes_and_map_lines(runs):
    js, ts, _, _ = runs
    assert ts.get_tracking_state() == TS.TrackingState.OK
    assert js.get_tracking_state() == JS.TrackingState.OK
    assert [e.ts for e in ts.trajectory[:2]] == [e.ts for e in js.trajectory[:2]]
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert ts.n_kfs == js.n_kfs >= 3
    assert int(ts.map.lns.valid.sum()) == int(np.asarray(js.map.lns.valid).sum()) >= 2


def test_median_line_inliers_match_jax(runs):
    js, ts, _, _ = runs
    assert len(ts.ln_in) == len(js.ln_in) >= N_FRAMES - 8
    assert np.median(ts.ln_in) == np.median(js.ln_in) >= 1


def test_each_frame_from_the_reference_state_matches_jax(runs):
    js, _, lock, steps = runs
    assert lock.ln_in == js.ln_in
    assert len(steps) >= N_FRAMES - 8
    for i, prev, args, kw, out, jn, tn in steps:
        assert tn == jn, i
        jr = jax_track_step(js.cam, prev, args, kw)
        for f in ("ll_gid", "ln_inlier", "n_ln_inliers", "lm_gid", "n_inliers"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(jr, f)),
                                          err_msg=f"frame {i}: {f}")
        np.testing.assert_allclose(out.Tcw.numpy(), np.asarray(jr.Tcw),
                                   atol=LOCKSTEP_POSE_ATOL, err_msg=f"frame {i}")
