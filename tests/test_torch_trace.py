"""The port's span recorder (`splslam_tpu_torch/trace.py`) on the CPU:
nesting, parents, self time and request ids; the ring's wrap; the spans
of a short stereo run with one keyframe call (one root span a call
carrying its frame index, one `frame.build` and two or more
`track.pose_gn` a tracked frame, `map.step` holding `map.upkeep` and
`map.local_ba`, the `host_reads` counter equal to the `host.read`
spans); the System's timer rows taken from the same clock reads; and
the shared clock: an event of torch.profiler opened inside a program
span lies inside it. At 320x240, 4 levels, 600 features, one torch
thread."""

import re
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from splslam_tpu_torch import trace as T
from splslam_tpu_torch.io.synthetic import make_stereo_sequence
from splslam_tpu_torch.slam import system as TS

PORT = Path(T.__file__).resolve().parent
ROWS = ["Tracking total / frame", "KeyFrame insertion", "Mapping total / keyframe",
        "Loop detection / keyframe"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread beside the other test files' workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextmanager
def _top(name, request):
    """A span opened with a request, as the System's public calls open theirs."""
    T.RECORDER.open(request)
    try:
        yield
    finally:
        T.RECORDER.close(name)


@T.span("test.leaf")
def _leaf(fail: bool = False):
    time.sleep(0.002)
    if fail:
        raise ValueError("inside a span")


def test_nesting_parents_self_time_and_requests():
    first = T.RECORDER.opened
    with _top("test.root", 7):
        with T.Span("test.inner"):
            _leaf()
        _leaf()
        with _top("call.nested", 9):     # a call inside a call keeps 7
            pass
    with T.Span("test.after"):
        pass
    recs = T.RECORDER.records(first)
    assert [r[1] for r in recs] == ["test.root", "test.inner", "test.leaf", "test.leaf",
                                    "call.nested", "test.after"]
    seq = [r[0] for r in recs]
    assert seq == list(range(first, first + 6))
    assert [r[4] for r in recs] == [-1, seq[0], seq[1], seq[0], seq[0], -1]
    assert [r[5] for r in recs] == [7, 7, 7, 7, 7, -1]
    for r in recs[1:5]:                  # each child inside its parent
        p = recs[seq.index(r[4])]
        assert p[2] <= r[2] <= r[3] <= p[3]
    s = T.summary(recs)
    assert s["test.leaf"]["n"] == 2 and s["test.leaf"]["total_ms"] >= 4.0
    root, inner = recs[0], recs[1]
    kids = sum(r[3] - r[2] for r in recs if r[4] == root[0])
    assert s["test.root"]["self_ms"] == pytest.approx((root[3] - root[2] - kids) / 1e6)
    assert s["test.inner"]["self_ms"] == pytest.approx(
        (inner[3] - inner[2] - (recs[2][3] - recs[2][2])) / 1e6)
    assert s["test.leaf"]["self_ms"] == pytest.approx(s["test.leaf"]["total_ms"])


def test_span_closes_when_its_body_raises():
    first = T.RECORDER.opened
    with pytest.raises(ValueError):
        with _top("test.root", 3):
            _leaf(fail=True)
    with _top("test.next", 4):
        pass
    recs = T.RECORDER.records(first)
    assert [(r[1], r[4] >= 0, r[5]) for r in recs] == [
        ("test.root", False, 3), ("test.leaf", True, 3), ("test.next", False, 4)]


def test_ring_wrap_is_detected():
    r = T.Recorder(capacity=4)
    for i in range(3):
        r.open(i)
        r.close(f"s{i}")
    assert not r.wrapped and [x[0] for x in r.records()] == [0, 1, 2]
    r.open(3)                            # an open span is not read
    assert [x[0] for x in r.records()] == [0, 1, 2]
    r.close("s3")
    for i in range(4, 6):
        r.open(i)
        r.close(f"s{i}")
    assert r.wrapped and r.opened == 6
    assert [x[0] for x in r.records()] == [2, 3, 4, 5]
    assert [x[0] for x in r.records(since=4)] == [4, 5]
    assert [x[5] for x in r.records()] == [2, 3, 4, 5]


def test_host_read_counts_on_the_cpu():
    first, n0 = T.RECORDER.opened, T.RECORDER.host_reads
    src = torch.arange(6, dtype=torch.float32)
    later = T.HostRead(src)
    now = T.read(src * 2)
    src.zero_()
    np.testing.assert_array_equal(now, np.arange(6) * 2.0)
    np.testing.assert_array_equal(later.get(), np.arange(6, dtype=np.float32))
    assert T.RECORDER.host_reads - n0 == 2
    assert [r[1] for r in T.RECORDER.records(first)] == ["host.read", "host.read"]


def test_no_profiler_ranges_in_the_port():
    """The program's spans stay out of the profiler: no module of the port
    opens a torch.profiler range."""
    hits = [str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
            if re.search(r"record_function", p.read_text())]
    assert hits == []


@pytest.fixture(scope="module")
def stereo_run():
    """Five stereo frames with a keyframe forced every 2 frames: the init
    frame, three tracked frames, and a keyframe call (frame 4, where
    frame 3's stats make the keyframe and its mapping step runs)."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=5, motion="forward", width=320,
                                            height=240)
    st = TS.Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
                     n_features=600, n_levels=4, th_depth=40.0, fps=10, max_points=8192,
                     max_keyframes=64, local_window=1024, force_kf_every=2)
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    first, reads0 = T.RECORDER.opened, T.RECORDER.host_reads
    grew = []
    for i, (l, r) in enumerate(frames):
        n = sysm.n_kfs
        sysm.track_stereo(l, r, i * 0.1)
        grew.append(sysm.n_kfs > n)
    recs = T.RECORDER.records(first)
    return sysm, recs, grew, T.RECORDER.host_reads - reads0


def _calls(recs):
    """Each top-level span with the spans opened under it."""
    out = []
    for r in recs:
        if r[4] < 0:
            out.append([r])
        else:
            out[-1].append(r)
    return out


def test_stereo_run_spans(stereo_run):
    sysm, recs, grew, reads = stereo_run
    calls = _calls(recs)
    assert [c[0][1] for c in calls] == ["call.track_stereo"] * 5
    assert [c[0][5] for c in calls] == list(range(5))           # the frame index
    assert all(r[5] == c[0][5] for c in calls for r in c)
    assert grew == [True, False, False, False, True]
    names = [[r[1] for r in c] for c in calls]
    assert all(n.count("frame.upload") == 1 and n.count("frame.build") == 1
               for n in names)
    for n in names[1:]:                                         # tracked frames
        assert n.count("track.pose_gn") >= 2 and n.count("track.match") >= 2
        assert n.count("track.window") == 1
    build = [r for r in calls[1] if r[1] == "frame.build"][0]
    under = {r[1] for r in calls[1] if r[4] == build[0]}
    assert under == {"frame.orb", "frame.stereo"}
    orb = [r for r in calls[1] if r[1] == "frame.orb"][0]
    assert sorted(r[1] for r in calls[1] if r[4] == orb[0]) == [
        "frame.orb.describe", "frame.orb.detect", "frame.orb.detect"]
    kf = calls[4]
    by = {r[1]: r for r in kf}
    for stage in ("kf.insert", "kf.bow", "map.step", "loop.detect"):
        assert stage in by, stage
    step = by["map.step"]
    for stage in ("map.upkeep", "map.local_ba"):
        r = by[stage]
        assert r[4] == step[0] and step[2] <= r[2] <= r[3] <= step[3]
    assert by["kf.bow"][4] == by["kf.insert"][0]
    assert "map.step" not in names[3]
    assert reads == sum(r[1] == "host.read" for r in recs) >= 4


def test_timer_rows_come_from_the_spans(stereo_run):
    """`timers.report()` keeps the JAX System's rows, in its order and with
    its counts; each sample is its span's length."""
    sysm, recs, _, _ = stereo_run
    rep = sysm.timers.report()
    assert list(rep) == ROWS
    assert [rep[k]["n"] for k in ROWS] == [5, 1, 1, 1]
    calls = [r for r in recs if r[1] == "call.track_stereo"]
    assert sysm.timers.samples[ROWS[0]] == [(r[3] - r[2]) / 1e6 for r in calls]
    for row, name in T.ROW_SPANS.items():
        (r,) = [x for x in recs if x[1] == name]
        assert sysm.timers.samples[row] == [(r[3] - r[2]) / 1e6]


def test_batch_row_is_its_span_over_its_frames():
    """A batch's one "Tracking total / frame" sample is its span's length
    over its frames; the bootstrap call inside the first batch is a child
    of it and keeps its own sample."""
    K, bf, frames, _ = make_stereo_sequence(n_frames=4, motion="forward", width=320,
                                            height=240)
    st = TS.Settings(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                     cy=float(K[1, 2]), bf=float(bf), width=320, height=240,
                     n_features=600, n_levels=4, th_depth=40.0, fps=10, max_points=8192,
                     max_keyframes=64, local_window=1024, enable_local_mapping=False,
                     enable_relocalization=False, enable_loop_closing=False,
                     min_kf_gap=100)
    sysm = TS.System(st, TS.Sensor.STEREO, "cpu")
    first = T.RECORDER.opened
    sysm.track_stereo_batch(frames, [i * 0.1 for i in range(4)])
    recs = T.RECORDER.records(first)
    outer = [r for r in recs if r[1] == "call.track_stereo_batch"]
    assert [r[4] for r in outer] == [-1, outer[0][0]]
    assert all(r[5] == 0 for r in recs)
    boot = [r for r in recs if r[1] == "call.track_stereo"]
    assert len(boot) == 1 and boot[0][4] == outer[0][0]
    assert sum(r[1] == "frame.build" for r in recs) == 4
    assert sysm.timers.samples[ROWS[0]] == [(boot[0][3] - boot[0][2]) / 1e6,
                                            (outer[1][3] - outer[1][2]) / 1e6 / 3]


def test_spans_share_the_profilers_clock():
    """Under a CPU torch.profiler, a profiler event opened inside a program
    span lies inside the span's recorded interval, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    first = T.RECORDER.opened
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.Span("test.clock"):
            time.sleep(0.003)
            with record_function("test.inside"):
                torch.ones(64).sum()
            time.sleep(0.003)
    (r,) = [x for x in T.RECORDER.records(first) if x[1] == "test.clock"]
    (e,) = [x for x in prof.profiler.kineto_results.events() if x.name() == "test.inside"]
    start, end = e.start_ns(), e.start_ns() + e.duration_ns()
    assert r[2] - 1_000_000 <= start <= end <= r[3] + 1_000_000
    assert start - r[2] >= 2_000_000 and r[3] - end >= 2_000_000   # not a 1 ms coincidence
