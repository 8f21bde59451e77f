"""What a `torch.profiler` trace of the window says about the device.

`merged_busy_us` and the reading of the profiler's raw kineto events
(the device's activities, their busy union, time by name) are a frozen
copy of `splslam_tpu_torch/bench/common.py::_merged_busy_us` and
`Bench.trace` at commit ba65753. Added here: host events, the idle gaps
of the device labelled by the host event that ran across each, and the
traced calls found by the span each ran in, under one profiler that is
started and stopped once (no schedule: a profiler stepped through cycles
without `acc_events` keeps only its last cycle's events).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

GAPS_LABELLED = 2000      # the longest idle gaps given a host label
MAX_WALK = 500            # host events looked at per gap


def merged_busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (us)."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """The device activities and host events of the traced calls, in us on
    the profiler's clock. One profiler covers every traced call; each call
    ran inside a host span of its own (`calls`: the start and end of each),
    and the traced window runs from the first call's start to the last
    call's end."""

    calls: list = field(default_factory=list)     # (start, end) of each traced call
    device: list = field(default_factory=list)    # (name, start, end)
    host: list = field(default_factory=list)      # (name, start, end), the calls' spans left out

    @property
    def window_s(self) -> float:
        return (self.calls[-1][1] - self.calls[0][0]) / 1e6

    @classmethod
    def read(cls, prof, span: str) -> "Trace":
        """The raw kineto events of a stopped profiler whose calls each ran
        inside a `record_function(span)` (building the profiler's
        FunctionEvents takes minutes for 10^6 activities)."""
        from torch.autograd import DeviceType

        t = cls()
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            rec = (e.name(), s, s + e.duration_ns() / 1e3)
            if rec[0] == span:          # the span's host range; its device twin is no activity
                if e.device_type() != DeviceType.CUDA:
                    t.calls.append(rec[1:])
            elif e.device_type() == DeviceType.CUDA:
                t.device.append(rec)
            else:
                t.host.append(rec)
        t.calls.sort()
        if not t.calls:
            raise RuntimeError("the profiler recorded no traced call")
        return t

    def device_ops_by_call(self) -> list[int]:
        """The device activities that start inside each call's span, or
        after it and before the next: the activities it enqueued."""
        starts = sorted(s for _, s, _ in self.device)
        edges = [c[0] for c in self.calls[1:]] + [np.inf]
        out, lo = [], bisect.bisect_left(starts, self.calls[0][0])
        for e in edges:
            hi = bisect.bisect_left(starts, e)
            out.append(hi - lo)
            lo = hi
        return out

    def busy_s(self) -> float:
        return merged_busy_us([(s, e) for _, s, e in self.device]) / 1e6

    def by_name(self) -> dict[str, tuple[float, int]]:
        """Device seconds and count of each activity name."""
        out: dict[str, list] = {}
        for name, s, e in self.device:
            r = out.setdefault(name, [0.0, 0])
            r[0] += (e - s) / 1e6
            r[1] += 1
        return {k: (v[0], v[1]) for k, v in out.items()}

    def top_ops(self, n: int = 10) -> list[list]:
        return [[k[:200], v[0]] for k, v in
                sorted(self.by_name().items(), key=lambda kv: -kv[1][0])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle seconds by what the host ran across each gap: the longest
        gaps, each labelled by the shortest host event spanning its
        middle ("host python" where none does), summed by label."""
        busy = merged([(s, e) for _, s, e in self.device])
        t0, t1 = self.calls[0][0], self.calls[-1][1]
        inside = [(max(s, t0), min(e, t1)) for s, e in busy if e > t0 and s < t1]
        edges = [t0] + [x for iv in inside for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        totals: dict[str, float] = {}
        for s, e in gaps[:GAPS_LABELLED]:
            mid = 0.5 * (s + e)
            label, best = "host python", np.inf
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - MAX_WALK, -1), -1):
                name, hs, he = host[j]
                if he >= mid and he - hs < best:
                    label, best = name, he - hs
            totals[label] = totals.get(label, 0.0) + (e - s) / 1e6
        return [[k[:200], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]


def spans(t: Trace) -> str:
    """The events a trace holds and the time each kind spans, for the log."""
    def span(recs):
        return (max(r[2] for r in recs) - min(r[1] for r in recs)) / 1e6 if recs else 0.0
    ops = t.device_ops_by_call()
    return (f"trace: {len(t.calls)} calls, {len(t.host)} host events over {span(t.host):.3f} s, "
            f"{len(t.device)} device activities over {span(t.device):.3f} s, traced window "
            f"{t.window_s:.3f} s, device activities a call {min(ops)}-{max(ops)}")
