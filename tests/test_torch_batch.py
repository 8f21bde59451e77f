"""Batched tracking in the PyTorch port (`pipeline.track_frames_batch`,
`vo_batch_step`, `vo_batch_step_mono`, `System.track_stereo_batch` /
`track_mono_batch` and the deferred batch stats) against the JAX
package's, on the CPU:

- the 12 forward frames of tests/test_e2e_stereo.py's batch test, B = 4,
  keyframes blocked (`min_kf_gap=100`), local mapping, relocalization
  and loop closing off: every stats row's integers equal to the JAX
  run's, poses within POSE_ATOL 1e-3 of it (tests/test_torch_system.py),
  and within 1e-4 of the port's own per-frame run (the JAX package's
  gate, tests/test_e2e_stereo.py:139);
- the same frames with local mapping on, a keyframe every 4 frames and
  each batch's stats read two batches late (`batch_defer_stats`, depth
  2): the keyframes' frame ids, the mapping steps, `health()` and the
  queue's depth after each batch equal to the JAX run's, poses within
  1e-3;
- `track_frames_batch` alone from that JAX run's final state (3
  keyframes, 2 mapping steps) over frames 12-15: one local window for
  the batch, equal to the JAX package's from the same state; stats
  integers, landmark ids and the point counters equal, poses within
  1e-4;
- tests/test_e2e_mono.py's `TestMonoBatched` scene (24 lateral frames,
  64 line slots, B = 6, relocalization and loop detection on as there)
  against JAX's `track_mono_batch`, with the JAX package's two-view
  draws (tests/test_torch_mono.py): the same init frames, model,
  keyframes and lost flags, poses within 2e-2 (tests/test_torch_mono.py's
  tolerance); and the port's batched run within 0.02 of its per-frame run
  (the JAX test's gate);

and the host side alone: staging, the bootstrap from a staged batch,
`reset` with batches in flight, the stats copy and the timer.

One JAX run per scene, in module fixtures; torch runs on one thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.slam import pipeline as JP
from splslam_tpu.slam import system as JS
from splslam_tpu_torch import convert
from splslam_tpu_torch.slam import mono as TM
from splslam_tpu_torch.slam import pipeline as TP
from splslam_tpu_torch.slam import system as TS
from test_torch_mono import jax_samples

POSE_ATOL = 1e-3
SEQ_ATOL = 1e-4      # batched against per-frame (tests/test_e2e_stereo.py:139)
MONO_ATOL = 2e-2     # tests/test_torch_mono.py
B = 4
NO_RELOC = dict(enable_relocalization=False, enable_loop_closing=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    # forward motion is frame i's own: frames[:12] are the 12-frame run's
    return make_stereo_sequence(n_frames=16, motion="forward", width=320, height=240)


def settings_kw(K, bf, **kw):
    return dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
                n_features=600, n_levels=4, th_depth=40.0, fps=10,
                max_points=8192, max_keyframes=64, local_window=1024, **kw)


def record_rows(sysm):
    """Keep every consumed batch's stats rows in `sysm.rows`, and the
    queue's depth after each dispatch in `sysm.depths`."""
    sysm.rows, sysm.depths = [], []
    consume = sysm._consume_batch_stats

    def recorded(fetch, *args):
        sysm.rows.append(np.array(fetch.get() if hasattr(fetch, "get")
                                  else np.asarray(fetch)))
        return consume(fetch, *args)

    sysm._consume_batch_stats = recorded
    return sysm


def run_batches(sysm, frames, b=B):
    for i in range(0, len(frames), b):
        chunk = frames[i:i + b]
        sysm.track_stereo_batch(chunk, [j * 0.1 for j in range(i, i + len(chunk))])
        if hasattr(sysm, "depths"):
            sysm.depths.append(len(sysm._pending_batches))
    sysm.drain()
    return sysm


@pytest.fixture(scope="module")
def plain_runs(scene):
    K, bf, frames, gt = scene
    kw = settings_kw(K, bf, enable_local_mapping=False, min_kf_gap=100, **NO_RELOC)
    js = run_batches(record_rows(JS.System(JS.Settings(**kw), JS.Sensor.STEREO)),
                     frames[:12])
    tb = run_batches(record_rows(TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")),
                     frames[:12])
    tp = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    for i, (l, r) in enumerate(frames[:12]):
        tp.track_stereo(l, r, i * 0.1)
    tp.drain()
    return js, tb, tp


@pytest.fixture(scope="module")
def mapping_runs(scene):
    K, bf, frames, gt = scene
    kw = settings_kw(K, bf, force_kf_every=4, batch_defer_stats=True,
                     batch_defer_depth=2, **NO_RELOC)
    js = run_batches(record_rows(JS.System(JS.Settings(**kw), JS.Sensor.STEREO)),
                     frames[:12])
    ts = run_batches(record_rows(TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")),
                     frames[:12])
    return js, ts


def _assert_poses(pa, pb, atol):
    assert pa.shape == pb.shape
    np.testing.assert_allclose(pa[:, :3, 3], pb[:, :3, 3], atol=atol)
    np.testing.assert_allclose(pa[:, :3, :3], pb[:, :3, :3], atol=atol)


def test_batched_stats_integers_match_jax(plain_runs):
    js, tb, _ = plain_runs
    assert len(tb.rows) == len(js.rows) == 3
    for rt, rj in zip(tb.rows, js.rows):
        assert rt.shape == rj.shape and rt.shape[1] == TP.STATS_LEN
        np.testing.assert_array_equal(rt[:, TP.S_N_MM:], rj[:, JP.S_N_MM:])
        np.testing.assert_allclose(rt[:, TP.S_POSE], rj[:, JP.S_POSE], atol=POSE_ATOL)


def test_batched_poses_follow_jax(plain_runs):
    js, tb, _ = plain_runs
    assert tb.get_tracking_state() == TS.TrackingState.OK
    assert not any(e.lost for e in tb.trajectory)
    assert tb.n_kfs == js.n_kfs == 1
    _assert_poses(tb.poses(), js.poses(), POSE_ATOL)


def test_batched_equals_per_frame(plain_runs):
    """tests/test_e2e_stereo.py's batched-equals-sequential, for the port."""
    _, tb, tp = plain_runs
    _assert_poses(tb.poses(), tp.poses(), SEQ_ATOL)
    assert tb.n_kfs == tp.n_kfs and tb.n_pts == tp.n_pts


def test_timer_counts_match_jax(plain_runs):
    """One "Tracking total / frame" sample for the bootstrap frame and one
    (its ms a frame) for each batch, as the JAX package records them."""
    js, tb, _ = plain_runs
    rt = tb.timers.report()["Tracking total / frame"]
    rj = js.timers.report()["Tracking total / frame"]
    assert rt["n"] == rj["n"] == 4
    assert rt["mean_ms"] > 0


def test_deferred_mapping_run_matches_jax(mapping_runs):
    js, ts = mapping_runs
    assert ts.get_tracking_state() == TS.TrackingState.OK
    assert not any(e.lost for e in ts.trajectory)
    assert ts.n_kfs == js.n_kfs >= 3
    np.testing.assert_array_equal(ts.map.kfs.frame_id[:ts.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert ts.mapper.n_steps == js.mapper.n_steps == ts.n_kfs - 1
    assert ts.health() == js.health()
    assert ts.health()["mapping_state_revert"] == 0
    assert ts.n_pts == js.n_pts
    _assert_poses(ts.poses(), js.poses(), POSE_ATOL)


def test_deferred_queue_depth_matches_jax(mapping_runs):
    """Depth 2: the third batch's dispatch consumes the first."""
    js, ts = mapping_runs
    assert ts.depths == js.depths == [1, 2, 2]
    assert not ts._pending_batches and not js._pending_batches
    for rt, rj in zip(ts.rows, js.rows):
        np.testing.assert_array_equal(rt[:, TP.S_N_MM:], rj[:, JP.S_N_MM:])


@pytest.fixture(scope="module")
def captured(scene, mapping_runs):
    """The JAX mapping run's final map and tracker state (numpy), frames
    12-15 as a staged batch, and the JAX package's `build_frames_batch` +
    `track_frames_batch` on them."""
    js, ts = mapping_runs
    _, _, frames, _ = scene
    imgs = np.stack([np.stack(f) for f in frames[12:16]]).astype(np.uint8)
    m_np, prev_np = jax.device_get((js.map, js.step))
    m_np = jax.tree.map(np.array, m_np)
    prev_np = jax.tree.map(np.array, prev_np)
    jf = JP.build_frames_batch(jnp.asarray(imgs), js.cam, js.spec, line_capacity=1)
    j_m_in = jax.tree.map(lambda x: jnp.asarray(np.array(x)), m_np)
    j_prev = jax.tree.map(jnp.asarray, prev_np)
    jwin = jax.device_get(JP.assemble_local_window(j_m_in, j_prev.lm_gid, 1024))
    out = jax.device_get(JP.track_frames_batch(
        jf, j_m_in, j_prev, js._th_depth_dev, jnp.int32(js.ref_kf), js.cam, js.scales,
        m_local=1024, scale_factor=1.2, n_levels=4))
    return ts, imgs, m_np, prev_np, jwin, out


def _port_batch(ts, imgs, m_np, prev_np):
    """The port's build + `track_frames_batch` from the captured state
    (the port's mapping run holds the same camera and pyramid)."""
    m = convert.map_state_from_numpy(m_np, "cpu")
    prev = convert.step_state_from_numpy(prev_np, "cpu")
    frames = TP.build_frames_batch(torch.from_numpy(imgs), ts.cam, ts.spec, ts.scales)
    return TP.track_frames_batch(frames, m, prev, ts.th_depth_m, ts.ref_kf, ts.cam,
                                 ts.scales, m_local=1024, scale_factor=1.2, n_levels=4)


def test_track_frames_batch_matches_jax(captured):
    ts, imgs, m_np, prev_np, _, (jm, jstate, jstats) = captured
    assert int(m_np.n_kfs) == 3 and ts.ref_kf == 2
    tm, tstate, tstats = _port_batch(ts, imgs, m_np, prev_np)
    tstats = tstats.numpy()
    assert tstats.shape == (4, TP.STATS_LEN)
    np.testing.assert_array_equal(tstats[:, TP.S_N_MM:], np.asarray(jstats)[:, JP.S_N_MM:])
    np.testing.assert_allclose(tstats[:, TP.S_POSE], np.asarray(jstats)[:, JP.S_POSE],
                               atol=SEQ_ATOL)
    assert int(tstats[:, TP.S_N_IN].min()) > 100
    np.testing.assert_array_equal(tstate.lm_gid.numpy(), np.asarray(jstate.lm_gid))
    for name in ("n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(tm.pts, name).numpy(),
                                      np.asarray(getattr(jm.pts, name)), err_msg=name)
    # the counters moved: every frame's visible landmarks were added
    assert int(tm.pts.n_visible.sum()) > int(m_np.pts.n_visible.sum())


def test_track_frames_batch_freezes_the_windows(captured, monkeypatch):
    """The local window is assembled once, from the state at batch entry,
    and every frame of the batch tracks against that one window."""
    ts, imgs, m_np, prev_np, jwin, _ = captured
    built, used = [], []
    assemble, body = TP.assemble_local_window, TP._track_body

    def counted(*args, **kw):
        built.append(assemble(*args, **kw))
        return built[-1]

    def recorded(*args, **kw):
        used.append(kw["win"])
        return body(*args, **kw)

    monkeypatch.setattr(TP, "assemble_local_window", counted)
    monkeypatch.setattr(TP, "_track_body", recorded)
    _port_batch(ts, imgs, m_np, prev_np)
    assert len(built) == 1 and len(used) == 4
    assert all(w is built[0] for w in used)
    np.testing.assert_array_equal(built[0].ids.numpy(), np.asarray(jwin.ids))
    np.testing.assert_array_equal(built[0].ok.numpy(), np.asarray(jwin.ok))


def test_build_frames_batch_is_per_frame_builds(scene):
    """One `build_frame_stereo` a frame, in order."""
    K, bf, frames, _ = scene
    st = TS.Settings(**settings_kw(K, bf))
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    imgs = sysm.upload_batch(frames[:2])
    batch = TP.build_frames_batch(imgs, sysm.cam, sysm.spec, sysm.scales)
    assert len(batch) == 2
    for f, (l, r) in zip(batch, frames[:2]):
        one = TP.build_frame_stereo(torch.from_numpy(l.astype(np.uint8)).float(),
                                    torch.from_numpy(r.astype(np.uint8)).float(),
                                    sysm.cam, sysm.spec, sysm.scales)
        torch.testing.assert_close(f.feat.desc, one.feat.desc, rtol=0, atol=0)
        torch.testing.assert_close(f.depth, one.depth, rtol=0, atol=0)


def test_upload_batch_stages_uint8_pairs(scene):
    K, bf, frames, _ = scene
    sysm = TS.System(TS.Settings(**settings_kw(K, bf, **NO_RELOC)), TS.Sensor.STEREO,
                     "cpu")
    staged = sysm.upload_batch(frames[:3])
    assert staged.shape == (3, 2, 240, 320) and staged.dtype == torch.uint8
    assert staged.device.type == "cpu"
    np.testing.assert_array_equal(staged[2, 1].numpy(), frames[2][1].astype(np.uint8))


def test_bootstrap_from_a_staged_batch(scene, plain_runs):
    """A staged tensor bootstraps the map from its first frame and tracks
    the rest as one batch: the same trajectory as the list's."""
    K, bf, frames, _ = scene
    _, tb, _ = plain_runs
    sysm = TS.System(tb.settings, TS.Sensor.STEREO, "cpu")
    staged = sysm.upload_batch(frames[:B])
    sysm.track_stereo_batch(staged, [j * 0.1 for j in range(B)])
    assert sysm.n_kfs == 1 and sysm.frame_id == B
    np.testing.assert_array_equal(sysm.poses(), tb.poses()[:B])


def test_reset_drops_batches_in_flight(scene):
    K, bf, frames, _ = scene
    kw = settings_kw(K, bf, enable_local_mapping=False, min_kf_gap=100,
                     batch_defer_stats=True, batch_defer_depth=3, **NO_RELOC)
    sysm = TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu")
    sysm.track_stereo_batch(frames[:3], [0.0, 0.1, 0.2])
    sysm.track_stereo_batch(frames[3:5], [0.3, 0.4])
    assert len(sysm._pending_batches) == 2 and len(sysm.trajectory) == 1
    sysm.reset()
    assert not sysm._pending_batches and not sysm._batch_recovering
    assert sysm.get_tracking_state() == TS.TrackingState.NO_IMAGES_YET
    assert sysm.n_kfs == 0 and len(sysm.trajectory) == 0


def test_stats_fetch_copies_on_the_cpu():
    stats = torch.arange(2 * TP.STATS_LEN, dtype=torch.float32).reshape(2, -1)
    fetch = TS._StatsFetch(stats)
    stats.zero_()
    np.testing.assert_array_equal(fetch.get()[1], np.arange(24, 48, dtype=np.float32))


def test_batch_settings_defaults_match_jax():
    for name in ("batch_defer_stats", "batch_defer_depth"):
        assert getattr(TS.Settings(), name) == getattr(JS.Settings(), name), name


# ---------------------------------------------------------------------
# monocular: tests/test_e2e_mono.py's TestMonoBatched scene
# ---------------------------------------------------------------------
MONO_B = 6


def _mono_batches(sysm, frames):
    for i in range(0, len(frames), MONO_B):
        chunk = [l for (l, _) in frames[i:i + MONO_B]]
        sysm.track_mono_batch(chunk, [j * 0.1 for j in range(i, i + len(chunk))])
    sysm.drain()
    return sysm


@pytest.fixture(scope="module")
def mono_runs():
    K, _, frames, gt = make_stereo_sequence(n_frames=24, motion="lateral", width=320,
                                            height=240, seed=3)
    kw = dict(settings_kw(K, 0.0), using_line=True, line_features=64,
              enable_local_mapping=False)
    kw.pop("th_depth")
    mp = pytest.MonkeyPatch()
    mp.setattr(TM, "draw_init_samples", jax_samples)
    try:
        js = _mono_batches(JS.System(JS.Settings(**kw), JS.Sensor.MONOCULAR), frames)
        tb = _mono_batches(TS.System(TS.Settings(**kw), TS.Sensor.MONOCULAR, "cpu"),
                           frames)
        tp = TS.System(TS.Settings(**kw), TS.Sensor.MONOCULAR, "cpu")
        for i, (l, _) in enumerate(frames):
            tp.track_mono(l, i * 0.1)
        tp.drain()
    finally:
        mp.undo()
    return js, tb, tp


def test_mono_batched_init_and_keyframes_match_jax(mono_runs):
    js, tb, _ = mono_runs
    assert tb.get_tracking_state() == TS.TrackingState.OK
    assert tb.init_used_h == js.init_used_h
    assert [e.ts for e in tb.trajectory[:2]] == [e.ts for e in js.trajectory[:2]]
    assert tb.n_kfs == js.n_kfs >= 3
    np.testing.assert_array_equal(tb.map.kfs.frame_id[:tb.n_kfs].numpy(),
                                  np.asarray(js.map.kfs.frame_id[:js.n_kfs]))
    assert [e.lost for e in tb.trajectory] == [e.lost for e in js.trajectory]
    assert tb.n_pts == js.n_pts


def test_mono_batched_poses_follow_jax(mono_runs):
    js, tb, _ = mono_runs
    _assert_poses(tb.poses(), js.poses(), MONO_ATOL)


def test_mono_batched_close_to_per_frame(mono_runs):
    """tests/test_e2e_mono.py's gate, for the port."""
    _, tb, tp = mono_runs
    pb, ps = tb.poses(), tp.poses()
    n = min(len(pb), len(ps))
    assert n >= 12
    assert np.linalg.norm(ps[:n, :3, 3] - pb[:n, :3, 3], axis=-1).max() < 0.02
