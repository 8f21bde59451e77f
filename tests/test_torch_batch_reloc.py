"""A loss inside the port's batched tracking, against the JAX package's,
on the CPU, at tests/test_reloc.py's settings (15 forward frames at
320x240, local mapping, relocalization and loop detection on with the
bundled 10^5-word vocabulary), each scenario run by both packages:

- tests/test_reloc.py's first kidnap: garbage from a batch's first frame
  to its end stays LOST; the next batch, garbage but for a final frame
  that revisits frame 6's view, is replayed one frame at a time and
  comes back OK within 0.08 m of frame 6's ground truth, with at most
  one keyframe more (the JAX gates); both batches replay;
- tests/test_reloc.py's second kidnap, the stats deferred
  (`batch_defer_stats`): garbage at a batch's first frame only, the next
  batch dispatched before the host reads the first; OK at the end, at
  most one of the last 8 frames lost, the last within 0.08 m of frame 12
  (the JAX gates). The device re-acquires frames 6-8 inside the first
  batch, a dip that heals by the batch's final frame, which is not
  replayed;
- a batch lost to its end while the next is in flight (deferred, depth
  2): the replay drops the newer batch's results and re-tracks its
  frames one at a time; OK at the end within 0.08 m of frame 9's ground
  truth, one replay, the frame counter where the per-frame path leaves
  it;

and, in each, the last 8 trajectory entries' lost flags, the state, the
keyframe count, the replays and the frame counter equal to the JAX
run's. On these sequences the per-frame replay recovers the view by the
reference-keyframe fallback, in both packages; `_try_relocalize` with a
batch row's frame id (`fid`) is held to the JAX package's on a saved and
reloaded map (the id it records, the winning keyframe, the pose within
0.05 m).

One JAX run per scenario, in module fixtures; torch runs on one thread."""

import numpy as np
import pytest
import torch

from splslam_tpu.io.synthetic import make_stereo_sequence
from splslam_tpu.slam import system as JS
from splslam_tpu_torch.slam import system as TS

GATE = 0.08          # tests/test_reloc.py


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return make_stereo_sequence(n_frames=15, motion="forward", width=320, height=240)


def settings_kw(K, bf, **kw):
    return dict(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
                n_features=600, n_levels=4, th_depth=40.0, fps=10,
                max_points=8192, max_keyframes=64, local_window=1024,
                enable_local_mapping=True, **kw)


def counted_replays(sysm):
    """Count `_recover_batch_suffix` calls in `sysm.replays`."""
    sysm.replays = 0
    replay = sysm._recover_batch_suffix

    def counted(*args):
        sysm.replays += 1
        return replay(*args)

    sysm._recover_batch_suffix = counted
    return sysm


BLANK = np.full((240, 320), 128.0, np.float32)


def _kidnap_to_batch_end(S, sysm, frames):
    out = {}
    for i, (l, r) in enumerate(frames):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    out["tracked"], out["n_kfs0"] = sysm.state.name, sysm.n_kfs
    sysm.track_stereo_batch([(BLANK, BLANK)] * 2, [1.5 + 0.1 * j for j in range(2)])
    sysm.drain()
    out["garbage"] = sysm.state.name
    sysm.track_stereo_batch([(BLANK, BLANK)] * 3 + [frames[6]],
                            [2.0 + 0.1 * j for j in range(4)])
    sysm.drain()
    return out


def _kidnap_mid_batch(S, sysm, frames):
    for i, (l, r) in enumerate(frames[:6]):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    out = {"tracked": sysm.state.name}
    sysm.track_stereo_batch([(BLANK, BLANK)] + [frames[6], frames[7], frames[8]],
                            [1.5 + 0.1 * j for j in range(4)])
    sysm.track_stereo_batch([frames[9], frames[10], frames[11], frames[12]],
                            [1.9 + 0.1 * j for j in range(4)])
    out["in_flight"] = len(sysm._pending_batches)
    sysm.drain()
    return out


def _both(scene, drive, **kw):
    K, bf, frames, gt = scene
    kw = settings_kw(K, bf, **kw)
    js = counted_replays(JS.System(JS.Settings(**kw), JS.Sensor.STEREO))
    ts = counted_replays(TS.System(TS.Settings(**kw), TS.Sensor.STEREO, "cpu"))
    return (js, drive(JS, js, frames)), (ts, drive(TS, ts, frames))


@pytest.fixture(scope="module")
def at_batch_end(scene):
    return _both(scene, _kidnap_to_batch_end)


@pytest.fixture(scope="module")
def mid_batch(scene):
    return _both(scene, _kidnap_mid_batch, batch_defer_stats=True)


def _lost_with_next_in_flight(S, sysm, frames):
    for i, (l, r) in enumerate(frames[:6]):
        sysm.track_stereo(l, r, i * 0.1)
    sysm.drain()
    out = {"tracked": sysm.state.name}
    sysm.track_stereo_batch([(BLANK, BLANK)] * 4, [1.5 + 0.1 * j for j in range(4)])
    sysm.track_stereo_batch(frames[6:10], [1.9 + 0.1 * j for j in range(4)])
    out["in_flight"] = len(sysm._pending_batches)
    sysm.drain()
    return out


@pytest.fixture(scope="module")
def next_in_flight(scene):
    return _both(scene, _lost_with_next_in_flight, batch_defer_stats=True,
                 batch_defer_depth=2)


def _same_as_jax(js, ts):
    assert ts.state.name == js.state.name
    assert ts.n_kfs == js.n_kfs and ts.frame_id == js.frame_id
    assert ts.replays == js.replays
    assert [e.lost for e in ts.trajectory[-8:]] == [e.lost for e in js.trajectory[-8:]]
    np.testing.assert_allclose(ts.poses()[-1][:3, 3], js.poses()[-1][:3, 3], atol=1e-3)


def test_kidnap_recovers_on_the_batch_final_frame(scene, at_batch_end):
    _, _, _, gt = scene
    _, (ts, out) = at_batch_end
    assert out["tracked"] == "OK" and out["garbage"] == "LOST"
    assert ts.state == TS.TrackingState.OK
    assert np.linalg.norm(ts.poses()[-1][:3, 3] - gt[6][:3, 3]) < GATE
    assert ts.n_kfs <= out["n_kfs0"] + 1
    assert ts.replays == 2
    assert ts.health()["mapping_state_revert"] == 0


def test_kidnap_at_batch_end_matches_jax(at_batch_end):
    (js, jout), (ts, tout) = at_batch_end
    assert tout == jout
    _same_as_jax(js, ts)


def test_midbatch_kidnap_recovers_mid_batch(scene, mid_batch):
    _, _, _, gt = scene
    _, (ts, out) = mid_batch
    assert out == {"tracked": "OK", "in_flight": 1}
    assert ts.state == TS.TrackingState.OK
    entries = ts.trajectory[-8:]
    assert sum(e.lost for e in entries) <= 1 and not entries[-1].lost
    assert np.linalg.norm(ts.poses()[-1][:3, 3] - gt[12][:3, 3]) < GATE
    # the first batch healed on the device: no replay
    assert ts.replays == 0 and not ts._pending_batches
    assert ts.frame_id == 6 + 8


def test_midbatch_kidnap_matches_jax(mid_batch):
    (js, jout), (ts, tout) = mid_batch
    assert tout == jout
    _same_as_jax(js, ts)


def test_lost_batch_replay_takes_the_batch_in_flight(scene, next_in_flight):
    _, _, _, gt = scene
    _, (ts, out) = next_in_flight
    assert out == {"tracked": "OK", "in_flight": 2}
    assert ts.state == TS.TrackingState.OK
    # one replay, which dropped the newer batch and re-tracked its frames;
    # the frame counter ends where the per-frame path leaves it
    assert ts.replays == 1 and not ts._pending_batches
    assert ts.frame_id == 6 + 8
    lost = [e.lost for e in ts.trajectory[-8:]]
    assert all(lost[:4]) and not any(lost[-3:])
    assert np.linalg.norm(ts.poses()[-1][:3, 3] - gt[9][:3, 3]) < GATE


def test_lost_batch_replay_matches_jax(next_in_flight):
    (js, jout), (ts, tout) = next_in_flight
    assert tout == jout
    _same_as_jax(js, ts)


def test_relocalize_records_the_batch_frame_id(scene, mid_batch, tmp_path):
    """`_try_relocalize(step, ts, fid)` on a reloaded map: a batch's final
    frame is relocalized under its own frame id, which the lost gate's
    post-relocalization window counts from."""
    K, bf, frames, gt = scene
    (js, _), (ts, _) = mid_batch
    found = []
    for sysm, S in ((js, JS), (ts, TS)):
        path = str(tmp_path / f"{S.__name__.split('.')[0]}.npz")
        sysm.save_map(path)
        fresh = (S.System(sysm.settings, S.Sensor.STEREO) if S is JS
                 else S.System(sysm.settings, S.Sensor.STEREO, "cpu"))
        fresh.load_map(path)
        step = _fresh_step(S, fresh, frames[11])
        ok = fresh._try_relocalize(step, 3.1, fid=123)
        found.append((ok, fresh._last_reloc_fid, fresh.ref_kf,
                      np.linalg.inv(fresh.last_Tcw_np)[:3, 3]))
    (jok, jfid, jkf, jpos), (tok, tfid, tkf, tpos) = found
    assert jok and tok and jfid == tfid == 123 and tkf == jkf
    assert np.linalg.norm(tpos - gt[11][:3, 3]) < 0.05
    assert np.linalg.norm(jpos - gt[11][:3, 3]) < 0.05


def _fresh_step(S, sysm, pair):
    """A tracker state holding `pair`'s frame, as the package builds it."""
    l, r = (np.asarray(x).astype(np.uint8) for x in pair)
    if S is JS:
        import jax.numpy as jnp

        from splslam_tpu.slam.frame import build_frame_stereo
        from splslam_tpu.slam.pipeline import StepState

        f = build_frame_stereo(jnp.asarray(l, jnp.float32), jnp.asarray(r, jnp.float32),
                               sysm.cam, sysm.spec, line_capacity=1)
        return StepState.fresh(f, jnp.asarray(sysm.last_Tcw_np))
    from splslam_tpu_torch.slam.frame import build_frame_stereo
    from splslam_tpu_torch.slam.pipeline import StepState

    f = build_frame_stereo(torch.from_numpy(l).float(), torch.from_numpy(r).float(),
                           sysm.cam, sysm.spec, sysm.scales, line_capacity=1)
    return StepState.fresh(f, torch.from_numpy(sysm.last_Tcw_np))
