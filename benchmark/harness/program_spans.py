"""The program's own spans and counters, read after the window.

`splslam_tpu_torch/trace.py` keeps a process-wide ring of span records
`(seq, name, start_ns, end_ns, parent_seq, request)`: `request` is the
frame index a public call was handed, which is the harness's
`Call.frame - Call.n_frames + 1`, and the times are Unix nanoseconds,
the clock of the profiler's events (`Trace` holds them in us). Here the
ring is cut into calls (a top-level `call.*` span and every span opened
after it until the next top-level span), the window's calls are found
by their request, and a stage's time is joined with the device trace.

A program without the recorder (an older checkout), a window whose first
call the ring no longer holds, or a window call the ring cannot find
reads as nothing: every reader here returns None then, never a number.
"""

from __future__ import annotations

import bisect

from harness.trace import merged

CALL = "call."
CLOCK_SLACK_US = 1000.0      # a root span may lie this far outside its traced call


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from splslam_tpu_torch import trace
    except ImportError:
        return None
    rec = getattr(trace, "RECORDER", None)
    return rec if hasattr(rec, "records") else None


def calls_by_request(records: list[tuple]) -> dict[int, list[tuple]]:
    """Each call's spans (its root first) by request id, from records in
    the order they were opened; where a request id recurs (a second
    System in the process) the last call keeps it."""
    out: dict[int, list[tuple]] = {}
    cur = None
    for r in records:
        if r[4] < 0:
            cur = [r] if r[1].startswith(CALL) else None
            if cur is not None:
                out[r[5]] = cur
        elif cur is not None:
            cur.append(r)
    return out


def request_of(call) -> int:
    return call.frame - call.n_frames + 1


def window_calls(ctx, traced: bool) -> list[tuple] | None:
    """[(harness call, its spans)] of the window's traced or untraced
    calls, or None where the ring cannot give every one of them."""
    rec = recorder()
    w = ctx.window
    if rec is None or not w.calls:
        return None
    by_req = calls_by_request(rec.records())
    if request_of(w.calls[0]) not in by_req:
        return None                 # the ring wrapped past the window's first call
    out = []
    for c in w.calls:
        if c.traced != traced:
            continue
        spans = by_req.get(request_of(c))
        if spans is None:
            return None
        out.append((c, spans))
    return out or None


def stage_ns(spans: list[tuple], name: str) -> int:
    """Summed length of the `name` spans, those inside another `name`
    span left out."""
    names = {r[0]: r[1] for r in spans}
    return sum(r[3] - r[2] for r in spans
               if r[1] == name and names.get(r[4]) != name)


def count(spans: list[tuple], name: str) -> int:
    return sum(r[1] == name for r in spans)


def stage_intervals_us(spans: list[tuple], name: str) -> list[tuple[float, float]]:
    """The `name` spans (outermost) as [start, end) in us, the trace's unit."""
    names = {r[0]: r[1] for r in spans}
    return [(r[2] / 1e3, r[3] / 1e3) for r in spans
            if r[1] == name and names.get(r[4]) != name]


def clock_agrees(ctx, traced: list[tuple]) -> bool:
    """Whether each traced call's root span lies within its profiler
    span (`Trace.calls`, in order) give or take CLOCK_SLACK_US."""
    t = ctx.window.trace
    if t is None or len(t.calls) != len(traced):
        return False
    for (s, e), (_, spans) in zip(t.calls, traced):
        root = spans[0]
        if root[2] / 1e3 < s - CLOCK_SLACK_US or root[3] / 1e3 > e + CLOCK_SLACK_US:
            return False
    return True


def idle_intervals_us(trace) -> list[tuple[float, float]]:
    """The device's idle intervals inside the traced window: the
    complement of the union of its activities."""
    t0, t1 = trace.calls[0][0], trace.calls[-1][1]
    out, at = [], t0
    for s, e in merged([(s, e) for _, s, e in trace.device]):
        if e <= t0 or s >= t1:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return out


def overlap_us(intervals: list[tuple[float, float]],
               idle: list[tuple[float, float]]) -> float:
    """Length of the parts of `intervals` that fall in the sorted,
    disjoint `idle`; `intervals` disjoint too."""
    starts = [s for s, _ in idle]
    total = 0.0
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(idle) and idle[i][0] < b:
            total += max(0.0, min(b, idle[i][1]) - max(a, idle[i][0]))
            i += 1
    return total


def idle_by_leaf_us(ctx) -> dict[str, float] | None:
    """The traced window's device idle time by the innermost program span
    open on the host meanwhile ("outside any span" where none is), over
    the traced calls; None where the clocks do not agree."""
    t = ctx.window.trace
    traced = window_calls(ctx, traced=True)
    if t is None or not t.device or traced is None or not clock_agrees(ctx, traced):
        return None
    idle = idle_intervals_us(t)
    out: dict[str, float] = {}
    covered = 0.0
    for _, spans in traced:
        inner: dict[int, list] = {}
        for r in spans:
            inner.setdefault(r[4], []).append((r[2] / 1e3, r[3] / 1e3))
        for r in spans:
            own = overlap_us([(r[2] / 1e3, r[3] / 1e3)], idle)
            kids = merged(inner.get(r[0], []))
            v = own - overlap_us(kids, idle)
            out[r[1]] = out.get(r[1], 0.0) + v
            covered += v
    total = sum(e - s for s, e in idle)
    out["outside any span"] = total - covered
    return out
