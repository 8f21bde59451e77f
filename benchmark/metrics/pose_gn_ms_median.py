"""The median over the window's untraced calls of the program's summed
`track.pose_gn` spans a frame (host ms): every `pose_optimize` solve,
whichever caller made it, as the host enqueues it."""

import numpy as np

from harness import program_spans as P

LAYER = "tracking"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    calls = P.window_calls(ctx, traced=False)
    if calls is None:
        return None
    return float(np.median([P.stage_ns(s, "track.pose_gn") / 1e6 / c.n_frames
                            for c, s in calls]))
