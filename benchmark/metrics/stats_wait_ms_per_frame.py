"""The program's summed `host.read` spans (host ms: the waits for the
device behind each blocking device-to-host read, the stats rows first)
in the window's untraced calls over their frames."""

from harness import program_spans as P

LAYER = "host control"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    calls = P.window_calls(ctx, traced=False)
    if calls is None:
        return None
    return (sum(P.stage_ns(s, "host.read") for _, s in calls) / 1e6
            / sum(c.n_frames for c, _ in calls))
