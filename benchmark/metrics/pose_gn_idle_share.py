"""The device's idle time while the host was inside a `track.pose_gn`
span, over the traced window's idle time (idle: the complement of the
union of the trace's CUDA activities). The spans are laid over the
trace on the shared Unix clock; where a traced call's root span does
not lie within its profiler span (1 ms either way), the reading is
missing."""

from harness import program_spans as P

LAYER = "device"
UNIT = "share"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    t = ctx.window.trace
    calls = P.window_calls(ctx, traced=True)
    if t is None or not t.device or calls is None or not P.clock_agrees(ctx, calls):
        return None
    idle = P.idle_intervals_us(t)
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    inside = sum(P.overlap_us(P.stage_intervals_us(s, "track.pose_gn"), idle)
                 for _, s in calls)
    return inside / total
