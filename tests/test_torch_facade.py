"""The rest of the port's System facade: localization mode on a stereo
and a monocular System, and the profiler trace.

Localization mode (reference System::ActivateLocalizationMode): the
stereo run is tests/test_e2e_stereo.py's localization scene (the init
frame, then 19 frames in localization mode): no keyframe after the
first, state OK, ATE < 0.08 (that test's gate); after
`deactivate_localization_mode` (20 more frames) keyframes resume. A
monocular System in localization mode (points and lines) inserts no
keyframe after its two-view bootstrap, where the same run without it
does. The frame step's temporal points are held against the JAX package
in tests/test_torch_tracking.py; the timer rows, `shutdown` and the
tracked-point queries in tests/test_torch_rgbd.py."""

import json

import numpy as np
import pytest
import torch

from splslam_tpu_torch.io.synthetic import ate_rmse, make_stereo_sequence
from splslam_tpu_torch.slam import system as TS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread beside the other test files' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(K, bf, **kw):
    return TS.Settings(**dict(dict(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        bf=float(bf), width=320, height=240, n_features=600, n_levels=4,
        th_depth=40.0, fps=10, max_points=8192, max_keyframes=64,
        local_window=1024, enable_local_mapping=False), **kw))


def test_stereo_localization_mode():
    """Without localization mode this run inserts keyframes at frames 10
    and 30; after it, the next comes at frame 35."""
    K, bf, frames, gt = make_stereo_sequence(n_frames=40, motion="forward",
                                             width=320, height=240)
    sysm = TS.System(_settings(K, bf), TS.Sensor.STEREO, "cpu")
    sysm.track_stereo(*frames[0], 0.0)
    sysm.activate_localization_mode()
    assert sysm.localization_only
    for i in range(1, 20):
        sysm.track_stereo(*frames[i], i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    assert sysm.n_kfs == 1
    assert not any(e.lost for e in sysm.trajectory)
    assert ate_rmse(sysm.poses(), gt[:20]) < 0.08
    sysm.deactivate_localization_mode()
    for i in range(20, 40):
        sysm.track_stereo(*frames[i], i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    assert sysm.n_kfs > 1
    assert ate_rmse(sysm.poses(), gt) < 0.08


@pytest.mark.parametrize("localization", [False, True])
def test_mono_localization_mode(localization):
    """The mono+lines scene of the port's verify recipe (keyframes at
    frames 0, 1, 5, 12, ...): with the flag set, none after the
    bootstrap's two."""
    K, _, frames, _ = make_stereo_sequence(n_frames=8, motion="lateral", width=320,
                                           height=240, texture="grid")
    sysm = TS.System(_settings(K, 0.0, using_line=True, line_features=64,
                               enable_relocalization=False, enable_loop_closing=False),
                     TS.Sensor.MONOCULAR, "cpu")
    if localization:
        sysm.activate_localization_mode()
    for i, (l, _) in enumerate(frames):
        sysm.track_mono(l, i * 0.1)
    assert sysm.get_tracking_state() == TS.TrackingState.OK
    if localization:
        assert sysm.n_kfs == 2
    else:
        assert sysm.n_kfs > 2


def test_device_trace_writes_a_trace(tmp_path):
    """`device_trace` records the block's activities and writes a trace for
    TensorBoard (here the CPU's activities), with the program's spans of
    the block added as host events inside the block's time."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=2, motion="forward",
                                            width=320, height=240)
    sysm = TS.System(_settings(K, bf, enable_relocalization=False,
                               enable_loop_closing=False), TS.Sensor.STEREO, "cpu")
    with TS.device_trace(str(tmp_path)):
        for i, (l, r) in enumerate(frames):
            sysm.track_stereo(l, r, i * 0.1)
        sysm.drain()
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert sum(e["name"] == "frame.build" for e in spans) == 2
    assert sum(e["name"] == "call.track_stereo" for e in spans) == 2
    ops = [e for e in events if str(e.get("name", "")).startswith("aten::")
           and e.get("ph") == "X"]
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    assert lo - 1000 <= min(e["ts"] for e in ops) and max(e["ts"] for e in ops) <= hi + 1000
    assert np.isfinite(sysm.poses()).all()
