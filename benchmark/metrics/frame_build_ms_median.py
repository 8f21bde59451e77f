"""The median over the window's untraced calls of the program's
`frame.build` spans a frame (host ms): ORB, stereo matching and lines as
the host enqueues them (`harness/program_spans.py`)."""

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
    return float(np.median([P.stage_ns(s, "frame.build") / 1e6 / c.n_frames
                            for c, s in calls]))
