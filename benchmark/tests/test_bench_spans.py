"""The six metrics that read the program's spans (`harness/program_spans.py`)
on hand-made spans and a hand-made `Trace`, each against the number it
should give; missing where the clocks disagree, where the ring wrapped
past the window's first call, where the program has no recorder, or
where the counter and the spans disagree; and once on a short CPU run of
the live cell."""

import time
import types

import pytest
from conftest import small_cell

import run as R
from harness import cell as C
from harness import program_spans as P
from harness.drive import Call, Window
from harness.trace import Trace
from splslam_tpu_torch import trace as PT

MS = 1_000_000          # ns
SPAN_METRICS = ["frame_build_ms_median", "pose_gn_ms_median", "host_reads_per_frame",
                "stats_wait_ms_per_frame", "pose_gn_idle_share", "local_ba_ms_per_keyframe"]


def ring(spans, capacity=None, host_reads=None):
    """A recorder holding `spans`, given as (name, start ms, end ms, parent
    index or -1, request) in the order they were opened."""
    rec = PT.Recorder(capacity or len(spans))
    for i, (name, a, b, parent, req) in enumerate(spans):
        rec.ring[i % rec.capacity] = (i, name, a * MS, b * MS, parent, req)
    rec.opened = len(spans)
    rec.host_reads = (sum(s[0] == "host.read" for s in spans) if host_reads is None
                      else host_reads)
    return rec


# call 10 untraced, 11 traced, 12 untraced with a keyframe; a read after
SPANS = [
    ("call.track_stereo", 0, 100, -1, 10),          # 0
    ("frame.build", 10, 40, 0, 10),
    ("track.pose_gn", 50, 60, 0, 10),
    ("track.pose_gn", 60, 75, 0, 10),
    ("host.read", 80, 81, 0, 10),
    ("call.track_stereo", 200, 300, -1, 11),        # 5
    ("frame.build", 205, 215, 5, 11),
    ("track.pose_gn", 220, 240, 5, 11),
    ("call.track_stereo", 400, 600, -1, 12),        # 8
    ("frame.build", 410, 430, 8, 12),
    ("track.pose_gn", 440, 450, 8, 12),
    ("host.read", 460, 462, 8, 12),
    ("kf.insert", 465, 470, 8, 12),
    ("map.step", 470, 590, 8, 12),                  # 13
    ("host.read", 475, 476, 13, 12),
    ("map.local_ba", 500, 580, 13, 12),
    ("host.read", 700, 701, -1, -1),
]
CALLS = [Call(10, 1, 100.0, False, False), Call(11, 1, 100.0, False, True),
         Call(12, 1, 200.0, True, False)]
EXPECTED = {"frame_build_ms_median": 25.0, "pose_gn_ms_median": 17.5,
            "host_reads_per_frame": 1.5, "stats_wait_ms_per_frame": 2.0,
            "pose_gn_idle_share": 0.5, "local_ba_ms_per_keyframe": 80.0}


def ctx_for(calls, trace=None):
    return types.SimpleNamespace(window=Window(calls=calls, trace=trace), cell=None)


def hand_trace(call_start_us=199_000.0):
    """The traced call's profiler span (us) and the device busy in
    [199, 230) and [250, 301) ms: idle 230-250 ms, half of it inside the
    traced call's pose solve (220-240 ms)."""
    return Trace(calls=[(call_start_us, 301_000.0)],
                 device=[("k", 199_000.0, 230_000.0), ("k", 250_000.0, 301_000.0)])


def read_all(ctx):
    return {n: C.metric_reader(n).read(ctx) for n in SPAN_METRICS}


@pytest.fixture
def use_ring(monkeypatch):
    def install(rec):
        monkeypatch.setattr(P, "recorder", lambda: rec)
    return install


def test_each_metric_reads_its_number(use_ring):
    use_ring(ring(SPANS))
    got = read_all(ctx_for(CALLS, hand_trace()))
    assert got == pytest.approx(EXPECTED)


def test_per_frame_metrics_divide_a_batch_by_its_frames(use_ring):
    spans = [("call.track_stereo_batch", 0, 100, -1, 1)]
    spans += [("frame.build", 10 * i, 10 * i + 8, 0, 1) for i in range(4)]
    spans += [("track.pose_gn", 50 + 5 * i, 53 + 5 * i, 0, 1) for i in range(8)]
    spans += [("host.read", 95, 97, 0, 1)]
    use_ring(ring(spans))
    got = read_all(ctx_for([Call(4, 4, 100.0, False, False)]))
    assert got["frame_build_ms_median"] == pytest.approx(8.0)
    assert got["pose_gn_ms_median"] == pytest.approx(6.0)
    assert got["host_reads_per_frame"] == pytest.approx(0.25)
    assert got["stats_wait_ms_per_frame"] == pytest.approx(0.5)
    assert got["local_ba_ms_per_keyframe"] is None and got["pose_gn_idle_share"] is None


def test_misaligned_clock_reads_as_missing(use_ring):
    use_ring(ring(SPANS))
    late = hand_trace(call_start_us=201_500.0)     # the root span starts 1.5 ms early
    assert C.metric_reader("pose_gn_idle_share").read(ctx_for(CALLS, late)) is None
    near = hand_trace(call_start_us=200_900.0)     # within 1 ms
    assert C.metric_reader("pose_gn_idle_share").read(ctx_for(CALLS, near)) is not None


def test_wrapped_ring_reads_as_missing(use_ring):
    use_ring(ring(SPANS, capacity=len(SPANS) - 1))  # call 10's root overwritten
    assert read_all(ctx_for(CALLS, hand_trace())) == dict.fromkeys(SPAN_METRICS)
    use_ring(ring(SPANS[5:], capacity=len(SPANS) - 5))
    got = read_all(ctx_for(CALLS[1:], hand_trace()))  # a window from call 11 on
    assert got["local_ba_ms_per_keyframe"] == pytest.approx(80.0)


def test_no_recorder_or_a_lost_call_reads_as_missing(use_ring):
    use_ring(None)
    assert read_all(ctx_for(CALLS, hand_trace())) == dict.fromkeys(SPAN_METRICS)
    use_ring(ring(SPANS))
    lost = CALLS + [Call(13, 1, 90.0, False, False)]      # an untraced call
    got = read_all(ctx_for(lost, hand_trace()))
    assert got == dict(dict.fromkeys(SPAN_METRICS), pose_gn_idle_share=pytest.approx(0.5))
    lost = [CALLS[0], Call(14, 1, 100.0, False, True), CALLS[2]]   # the traced call
    got = read_all(ctx_for(lost, hand_trace()))
    assert got["pose_gn_idle_share"] is None and got["frame_build_ms_median"] == 25.0


def test_reads_must_add_up_to_the_counter(use_ring):
    use_ring(ring(SPANS, host_reads=5))
    got = read_all(ctx_for(CALLS, hand_trace()))
    assert got["host_reads_per_frame"] is None
    assert got["stats_wait_ms_per_frame"] == pytest.approx(2.0)


def test_a_later_system_keeps_a_request_id(use_ring):
    """Two Systems in one process: the window's calls are the later ones."""
    old = [("call.track_stereo", 0, 50, -1, 10), ("frame.build", 1, 49, 0, 10)]
    new = [(n, a + 1000, b + 1000, p + 2 if p >= 0 else -1, r) for n, a, b, p, r in SPANS]
    use_ring(ring(old + new))
    got = read_all(ctx_for(CALLS))
    assert got["frame_build_ms_median"] == pytest.approx(25.0)
    assert got["local_ba_ms_per_keyframe"] == pytest.approx(80.0)


def test_idle_by_leaf_span(use_ring):
    use_ring(ring(SPANS))
    got = P.idle_by_leaf_us(ctx_for(CALLS, hand_trace()))
    # idle 230-250 ms: 230-240 inside the pose solve, 240-250 in the call
    # itself; none before the call starts or after it ends
    assert got == pytest.approx({"call.track_stereo": 10_000.0, "frame.build": 0.0,
                                 "track.pose_gn": 10_000.0, "outside any span": 0.0})


def test_live_cell_on_the_cpu_reads_the_span_metrics():
    cell = small_cell("kitti_stereo.live_mapping")
    cell.traffic["settings"]["force_kf_every"] = 3
    m = R.measure(cell, 2 ** 31 + 99, 4.0, True, "cpu", time.perf_counter())
    got = read_all(m)
    assert got["pose_gn_idle_share"] is None                  # no device on the CPU
    for name in ("frame_build_ms_median", "pose_gn_ms_median", "host_reads_per_frame",
                 "stats_wait_ms_per_frame"):
        assert got[name] is not None and got[name] > 0, name
    untraced = P.window_calls(m, traced=False)
    assert [P.request_of(c) for c, _ in untraced] == [s[0][5] for _, s in untraced]
    assert all(P.count(s, "frame.build") == 1 for _, s in untraced)
