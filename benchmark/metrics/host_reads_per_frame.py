"""The program's blocking device-to-host reads (its `host_reads` counter,
one a `host.read` span) in the window's untraced calls over their
frames. Where the ring holds every span, the spans must add up to the
counter, or the reading is missing."""

from harness import program_spans as P

LAYER = "host control"
UNIT = "reads/frame"
SOURCE = "program_counter"
MOVES = "frames_per_s"


def read(ctx):
    calls = P.window_calls(ctx, traced=False)
    rec = P.recorder()
    if calls is None or rec is None:
        return None
    if not rec.wrapped and P.count(rec.records(), "host.read") != rec.host_reads:
        return None
    return sum(P.count(s, "host.read") for _, s in calls) / sum(c.n_frames for c, _ in calls)
